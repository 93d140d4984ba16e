"""Self-supervised auxiliary objectives (port of ``druglamp_tpu/models/ssl.py``).

- Protein MLM: mask 15% of the non-pad tokens (replace probability 0.9, mask
  id 26), re-encode through the *shared* ProteinCNN (the model's own
  ``protein_extractor``, the same module object: the re-encode updates its
  BatchNorm running stats a second time in a step), project to 27 logits;
  the LLM branch projects the frozen ESM embeddings.  Mode ``double`` | ``vp``
  | ``xp`` selects the branches.
- Drug SimSiam: per-token projections of GCN tokens and ChemBERTa tokens
  (every row of (B·N, C), padded nodes included) through the SimSiam MLPs,
  a predictor head, stop-gradient targets (``.detach()`` of the same
  projections), negative cosine ×2.  NT-Xent (SimCLR) is the alternative.

The heads compute in f32 (``Dense`` promotes a bf16 input with its f32
weight, as the JAX package's ``TorchDense`` does); ``_masked_ce`` casts the
logits to f32.  A model without the LLM stream builds only ``to_logits``
(the JAX model creates no parameters for the others).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from druglamp_tpu_torch.losses import masking
from druglamp_tpu_torch.nn.layers import Dense, TorchBatchNorm


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


class SimSiamMLP(nn.Module):
    """dim → hidden (BN, ReLU) → hidden (BN, ReLU) → out (BN, no affine); no biases."""

    def __init__(self, in_dim: int, proj_out: int, hidden_size: int = 512, bn_groups: int = 1):
        super().__init__()
        self.l1 = Dense(in_dim, hidden_size, bias=False)
        self.bn1 = TorchBatchNorm(hidden_size, groups=bn_groups)
        self.l2 = Dense(hidden_size, hidden_size, bias=False)
        self.bn2 = TorchBatchNorm(hidden_size, groups=bn_groups)
        self.l3 = Dense(hidden_size, proj_out, bias=False)
        self.bn3 = TorchBatchNorm(proj_out, affine=False, groups=bn_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.l1(x)))
        x = F.relu(self.bn2(self.l2(x)))
        return self.bn3(self.l3(x))


class PredictorMLP(nn.Module):
    def __init__(self, in_dim: int, proj_out: int, hidden_size: int, bn_groups: int = 1):
        super().__init__()
        self.l1 = Dense(in_dim, hidden_size)
        self.bn = TorchBatchNorm(hidden_size, groups=bn_groups)
        self.l2 = Dense(hidden_size, proj_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l2(F.relu(self.bn(self.l1(x))))


def negcos_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2 − 2·cos(x, y) per row."""
    return 2.0 - 2.0 * (_l2norm(x) * _l2norm(y)).sum(dim=-1)


def nt_xent_loss(queries: torch.Tensor, keys: torch.Tensor,
                 temperature: float = 0.1) -> torch.Tensor:
    """SimCLR NT-Xent over the 2b rows of [queries; keys]."""
    b = queries.shape[0]
    n = 2 * b
    projs = torch.cat([queries, keys], dim=0)
    logits = projs @ projs.T
    eye = torch.eye(n, dtype=torch.bool, device=projs.device)
    logits = torch.where(eye, torch.full((), -torch.inf, device=projs.device), logits) / temperature
    ar = torch.arange(b, device=projs.device)
    labels = torch.cat([ar + b, ar])
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).sum() / n


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 0) -> torch.Tensor:
    """CE over (B, L, V) logits (in f32), mean over the labels != ignore_index."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    valid = (labels != ignore_index).float()
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


class SSL(nn.Module):
    """The auxiliary SSL heads.  ``prot_extractor`` is the model's ProteinCNN,
    held by reference and not registered here (its parameters belong to the
    model's ``protein_extractor``)."""

    def __init__(self, prot_extractor: nn.Module, n_prot_feature: int, n_drug_feature: int,
                 n_hidden: int = 128, drug_ssl_type: str = "simsiam", uses_llm: bool = True,
                 bn_groups: int = 1):
        super().__init__()
        self._shared = (prot_extractor,)
        self.drug_ssl_type = drug_ssl_type
        self.temperature = 0.1
        self.to_logits = Dense(n_hidden, 27)
        if uses_llm:
            self.llm_to_logits = Dense(n_prot_feature + 1, 27)
            self.net = SimSiamMLP(n_hidden, n_hidden, bn_groups=bn_groups)
            self.llm_net = SimSiamMLP(n_drug_feature + 1, n_hidden, bn_groups=bn_groups)
            if drug_ssl_type == "simsiam":
                self.predictor = PredictorMLP(n_hidden, n_hidden, n_hidden * 4,
                                              bn_groups=bn_groups)

    @property
    def prot_extractor(self) -> nn.Module:
        return self._shared[0]

    def prot_mlm(self, seq, xp, fill_bit, mode: str,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        masked_seq, labels, _ = masking.mlm_mask(seq, generator)
        losses = []
        if mode != "xp":
            embedding = self.prot_extractor(masked_seq, fill_bit)
            losses.append(_masked_ce(self.to_logits(embedding), labels))
        if mode != "vp":
            losses.append(_masked_ce(self.llm_to_logits(xp), labels))
        return sum(losses) / len(losses)

    def drug_simsiam(self, vd: torch.Tensor, xd: torch.Tensor) -> torch.Tensor:
        proj_one = self.net(vd.reshape(-1, vd.shape[-1]))
        proj_two = self.llm_net(xd.reshape(-1, xd.shape[-1]))
        pred_one = self.predictor(proj_one)
        pred_two = self.predictor(proj_two)
        # stop-gradient targets: the same projections, detached
        loss = negcos_loss(pred_one, proj_two.detach()) + negcos_loss(pred_two, proj_one.detach())
        return loss.mean()

    def drug_simclr(self, vd: torch.Tensor, xd: torch.Tensor) -> torch.Tensor:
        queries = self.net(vd.reshape(-1, vd.shape[-1]))
        keys = self.llm_net(xd.reshape(-1, xd.shape[-1]))
        return nt_xent_loss(queries.reshape(queries.shape[0], -1),
                            keys.reshape(keys.shape[0], -1), self.temperature)

    def forward(self, vp, xp, fill_bit_p, vd, xd, generator: Optional[torch.Generator],
                p_mode: str = "double") -> Dict[str, torch.Tensor]:
        prot_ssl = self.prot_mlm(vp, xp, fill_bit_p, p_mode, generator)
        if vd is None or xd is None:
            drug_ssl = torch.zeros((), device=prot_ssl.device)
        elif self.drug_ssl_type == "simsiam":
            drug_ssl = self.drug_simsiam(vd, xd)
        else:
            drug_ssl = self.drug_simclr(vd, xd)
        return {"prot_ssl": prot_ssl, "drug_ssl": drug_ssl}
