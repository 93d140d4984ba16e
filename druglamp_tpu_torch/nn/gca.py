"""PGCA guided cross-attention (port of ``druglamp_tpu/nn/gca.py``).

Batch-first (B, L, E) query against (B, S, E) key/value.  ``in_proj_weight``
is torch MultiheadAttention's packed (3E, E) layout (q, k, v row blocks); the
scaling is applied after the bias, and the pre-softmax scaled logits
(B, H, L, S) are returned for ``need_raw``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from druglamp_tpu_torch.nn import inits
from druglamp_tpu_torch.nn.layers import Dense


class GuidedCrossAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Dense(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                need_raw: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """query (B,L,E), key/value (B,S,E) → (out (B,L,E), raw logits (B,H,L,S))."""
        E, H = self.embed_dim, self.num_heads
        hd = E // H
        cd = self.compute_dtype or query.dtype
        wq, wk, wv = self.in_proj_weight.to(cd).chunk(3, dim=0)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        # a bf16 product plus the f32 bias promotes to f32, as in the reference
        q = (query.to(cd) @ wq.t() + bq) * hd ** -0.5
        k = key.to(cd) @ wk.t() + bk
        v = value.to(cd) @ wv.t() + bv

        B, L, _ = q.shape
        S = k.shape[1]
        q = q.reshape(B, L, H, hd).transpose(1, 2)
        k = k.reshape(B, S, H, hd).transpose(1, 2)
        v = v.reshape(B, S, H, hd).transpose(1, 2)

        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = torch.softmax(logits, dim=-1).to(cd)
        out = torch.matmul(attn.float(), v.float()).to(cd)
        out = self.out_proj(out.transpose(1, 2).reshape(B, L, E))
        return out, (logits if need_raw else None)

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        # xavier over the whole packed matrix, as torch's _reset_parameters does
        inits.uniform_(self.in_proj_weight, math.sqrt(6.0 / (4 * self.embed_dim)), g)
        with torch.no_grad():
            self.in_proj_bias.zero_()
