"""Cross-modality margin-scheduled triplet loss (port of
``druglamp_tpu/models/cm.py``, groups=1).

The triplet miner is a masked dense computation over the batch's (B, B)
ground truth (``data/device_data.py::cm_arrays_device``): ``p_index`` /
``d_index`` (B,) pick each unique entity slot's batch row, ``p_valid`` /
``d_valid`` (B,) mark the slots in use, ``gt`` (B, B) holds the label of
each (protein slot, drug slot) pair, 0 for an unobserved pair and −1 for a
padded slot.

  loss = Σᵢ Σ_{j⁺,j⁻} relu(D[i,j⁺] − D[i,j⁻] + margin)        (rows with positives)
       + Σᵢ Σ_{j⁻}    relu(D_pp[i] − D[i,j⁻] + margin)         (fallback rows)

over the triplet count (at least 1), with D[i,j] = 1 − sigmoid(cos(p_i, d_j)).
Everything after the entity selection computes in f32, as the JAX module
does (its MaskedBatchNorm promotes to f32).  The selection (``_rows``) pools
each row first and picks the slots' rows by a one-hot product: the same
values as the JAX module's take-then-mean, and a backward that is a matrix
product, which sums in a fixed order (``index_select``'s backward adds with
atomics on a card, so two steps from one seed could differ).  Per-replica
mining (groups > 1) belongs to the multi-GPU slice and raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from druglamp_tpu_torch.nn.layers import Dense, MaskedBatchNorm, _check_groups


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def _rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along dim 0 as one_hot(index) @ x (exact: one term per row)."""
    onehot = index.long()[:, None] == torch.arange(x.shape[0], device=x.device)[None, :]
    return onehot.to(x.dtype) @ x


class Mean2Embed(nn.Module):
    """MaskedBatchNorm → ReLU → Linear over pooled embeddings."""

    def __init__(self, in_dim: int, hidden: int = 128, groups: int = 1):
        super().__init__()
        self.bn = MaskedBatchNorm(in_dim, groups=groups)
        self.lin = Dense(in_dim, hidden)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return self.lin(F.relu(self.bn(x, valid)))


class CrossModality(nn.Module):
    def __init__(self, hidden_size: int = 128, groups: int = 1):
        super().__init__()
        _check_groups(groups)
        h = hidden_size
        self.prot2latent = Mean2Embed(h, h)
        self.aug_prot2latent = Mean2Embed(h, h)
        self.drug2latent = Mean2Embed(h, h)
        self.aug_drug2latent = Mean2Embed(h, h)
        self.to_prot_latent = Dense(2 * h, 2 * h, bias=False)
        self.to_drug_latent = Dense(2 * h, 2 * h, bias=False)

    def forward(self, prot, aug_prot, drug, aug_drug, p_index, p_valid, d_index, d_valid, gt,
                margin) -> torch.Tensor:
        p = self.prot2latent(_rows(prot.mean(dim=1), p_index), p_valid)
        ap = self.aug_prot2latent(_rows(aug_prot.mean(dim=1), p_index), p_valid)
        d = self.drug2latent(_rows(drug.mean(dim=1), d_index), d_valid)
        ad = self.aug_drug2latent(_rows(aug_drug.mean(dim=1), d_index), d_valid)

        p_lats = _l2norm(self.to_prot_latent(torch.cat([p, ap], dim=-1)))
        d_lats = _l2norm(self.to_drug_latent(torch.cat([d, ad], dim=-1)))
        return triplet_loss(p_lats, d_lats, p_valid, d_valid, gt, margin)


def triplet_loss(p_lats: torch.Tensor, d_lats: torch.Tensor, p_valid: torch.Tensor,
                 d_valid: torch.Tensor, gt: torch.Tensor, margin) -> torch.Tensor:
    """The masked dense triplet loss over the (P, D) slots (module docstring)."""
    p_valid, d_valid = p_valid.bool(), d_valid.bool()
    cos_pd = p_lats @ d_lats.T                                   # (P, D)
    dist = 1.0 - torch.sigmoid(cos_pd)
    self_cos = (p_lats * p_lats).sum(dim=-1)                     # ≈ 1 for valid rows
    dist_pp = 1.0 - torch.sigmoid(self_cos)                      # (P,)

    pos = (gt == 1) & d_valid[None, :]
    neg = (gt == 0) & d_valid[None, :]
    posf, negf = pos.float(), neg.float()
    n_pos, n_neg = posf.sum(dim=1), negf.sum(dim=1)
    has_pos = (n_pos > 0) & p_valid
    has_neg = (n_neg > 0) & p_valid

    # anchor = protein, positive / negative = drugs: relu(D⁺ − D⁻ + m) over pos × neg
    viol = F.relu(dist[:, :, None] - dist[:, None, :] + margin)   # (P, D⁺, D⁻)
    pair_mask = posf[:, :, None] * negf[:, None, :]
    term_pairs = (viol * pair_mask).sum(dim=(1, 2)) * has_pos.float()

    # fallback: anchor = positive = protein against each negative drug
    viol_fb = F.relu(dist_pp[:, None] - dist + margin)            # (P, D)
    fb_mask = (has_neg & ~has_pos).float()
    term_fb = (viol_fb * negf).sum(dim=1) * fb_mask

    n_tri = (n_pos * n_neg * has_pos.float()).sum() + (n_neg * fb_mask).sum()
    n_tri = torch.clamp(n_tri, min=1.0)
    return (term_pairs.sum() + term_fb.sum()) / n_tri
