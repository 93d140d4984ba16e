"""Cross-modality margin-scheduled triplet loss (port of
``druglamp_tpu/models/cm.py``).

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
mining and mining over several ranks: ``CrossModality``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from druglamp_tpu_torch.nn.layers import Dense, MaskedBatchNorm, _local_groups
from druglamp_tpu_torch.parallel import mesh as dp


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
    """``groups > 1``: per-replica mining (torch DDP's): each of ``groups``
    contiguous blocks of the batch mines its own triplets from its block of
    the ground truth ((groups, B/groups) arrays, block-local row indices, as
    ``BatchLoader(cm_groups=groups)`` builds them), each block's loss over
    its own triplet count, and the loss is the mean over the blocks; over N
    ranks each rank holds groups/N blocks.  ``groups == 1`` in a step over
    several ranks: every rank gathers the pooled streams of every rank's rows
    (``MeshContext.gather_rows``) and mines the whole batch from its ground
    truth, so each computes the single program's loss."""

    def __init__(self, hidden_size: int = 128, groups: int = 1):
        super().__init__()
        h = hidden_size
        self.groups = groups
        self.prot2latent = Mean2Embed(h, h, groups)
        self.aug_prot2latent = Mean2Embed(h, h, groups)
        self.drug2latent = Mean2Embed(h, h, groups)
        self.aug_drug2latent = Mean2Embed(h, h, groups)
        self.to_prot_latent = Dense(2 * h, 2 * h, bias=False)
        self.to_drug_latent = Dense(2 * h, 2 * h, bias=False)

    def forward(self, prot, aug_prot, drug, aug_drug, p_index, p_valid, d_index, d_valid, gt,
                margin) -> torch.Tensor:
        pooled = [s.mean(dim=1) for s in (prot, aug_prot, drug, aug_drug)]
        ctx = dp.current()
        if ctx is not None and self.groups == 1:
            pooled = ctx.gather_rows(torch.cat(pooled, dim=-1)).split(pooled[0].shape[-1], -1)
        g = p_index.shape[0] if self.groups > 1 else 1
        if self.groups > 1:
            # block-local row indices → rows of the flat batch
            if p_index.dim() != 2 or g != _local_groups(self.groups)[0]:
                raise ValueError(f"CM ground truth of shape {tuple(p_index.shape)} for "
                                 f"{self.groups} groups")
            off = (torch.arange(g, device=p_index.device) * (pooled[0].shape[0] // g))[:, None]
            p_index, d_index = (p_index + off).reshape(-1), (d_index + off).reshape(-1)
            p_valid, d_valid = p_valid.reshape(-1), d_valid.reshape(-1)
        p = self.prot2latent(_rows(pooled[0], p_index), p_valid)
        ap = self.aug_prot2latent(_rows(pooled[1], p_index), p_valid)
        d = self.drug2latent(_rows(pooled[2], d_index), d_valid)
        ad = self.aug_drug2latent(_rows(pooled[3], d_index), d_valid)

        p_lats = _l2norm(self.to_prot_latent(torch.cat([p, ap], dim=-1)))
        d_lats = _l2norm(self.to_drug_latent(torch.cat([d, ad], dim=-1)))
        if g == 1:
            return triplet_loss(p_lats, d_lats, p_valid, d_valid, gt.reshape(gt.shape[-2:]),
                                margin)
        blocks = zip(p_lats.chunk(g), d_lats.chunk(g), p_valid.chunk(g), d_valid.chunk(g), gt)
        return torch.stack([triplet_loss(*b, margin) for b in blocks]).mean()


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
