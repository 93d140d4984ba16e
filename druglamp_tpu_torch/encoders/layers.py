"""What the two frozen encoders (``encoders/esm2.py``, ``encoders/chemberta.py``)
share: the reference's embedding lookup, the attention core, and seeded
random weights."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from druglamp_tpu_torch.nn.layers import matmul_f32


def take(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``weight`` at ``ids``; NaN rows for ids outside the table, as
    the reference's ``jnp.take`` (mode 'fill') gives, where ``F.embedding``
    would fault on the card.  An id past the table (a wrong pad id walking
    ChemBERTa's positions out of range) then poisons the output, and the
    pipeline's finiteness guard refuses it."""
    valid = (ids >= 0) & (ids < weight.shape[0])
    rows = weight[ids.clamp(0, weight.shape[0] - 1)]
    return torch.where(valid[..., None], rows, torch.full((), float("nan"), dtype=rows.dtype,
                                                          device=rows.device))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad_mask: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """softmax(q kᵀ/√D) v over (B, H, L, D) heads: logits and probabilities
    in f32, pad keys at ``finfo(f32).min``, the probabilities rounded to
    ``dtype`` and the product accumulated in f32, returned in ``dtype``."""
    logits = matmul_f32(q, k.transpose(-1, -2), dtype) / math.sqrt(q.shape[-1])
    logits = logits.masked_fill(pad_mask[:, None, None, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return matmul_f32(probs, v, dtype).to(dtype)


def seeded_state(model: nn.Module, seed: int, dense_std: Optional[float] = None
                 ) -> Dict[str, torch.Tensor]:
    """Random weights for an encoder as a CPU state dict, drawn in
    ``model.state_dict()`` order from a ``torch.Generator`` seeded with
    ``seed``, so they are the same whatever device the model is on:
    embeddings (keys naming ``embed``) N(0, 0.02²), Dense weights
    xavier-uniform (``dense_std`` None) or N(0, dense_std² / fan_in), biases
    0, LayerNorm scales 1."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for key, ref in model.state_dict().items():
        t = torch.empty(ref.shape, dtype=torch.float32)
        name = key.rpartition(".")[0] if key.endswith((".weight", ".bias")) else key
        if "embed" in name:
            t.normal_(0.0, 0.02, generator=g)
        elif key.endswith(".bias"):
            t.zero_()
        elif t.dim() == 1:
            t.fill_(1.0)
        elif dense_std is None:
            fan_out, fan_in = t.shape
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            t.uniform_(-bound, bound, generator=g)
        else:
            t.normal_(0.0, dense_std / math.sqrt(t.shape[1]), generator=g)
        state[key] = t
    return state
