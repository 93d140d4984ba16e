"""Multi-head linear attention — content-gated sequence scaling (port of
``druglamp_tpu/nn/mhla.py``).

Per position an MLP (lin1 d_model→d_diff, act, lin2 →nhead) gives nhead
scalars, softmaxed in f32 over the *sequence* axis.  The gate (B, nhead, L)
then scales v after a raw row-major ``reshape(B*H, L, head_dim)``: that
reshape reinterprets the contiguous (L, E) buffer and is not a head split.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from druglamp_tpu_torch.nn.layers import Dense, dropout, gelu

_ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu, "gelu": gelu}


class MultiHeadLinearAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int = 8, d_diff: int = 32, dropout: float = 0.1,
                 activation: str = "tanh", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.nhead = nhead
        self.act = _ACTIVATIONS[activation]
        self.lin1 = Dense(d_model, d_diff, dtype=dtype)
        self.lin2 = Dense(d_diff, nhead, dtype=dtype)
        self.dropout_rate = dropout

    def forward(self, v: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in train mode."""
        attn = dropout(self.act(self.lin1(v)), self.dropout_rate, self.training, generator)
        attn = dropout(self.lin2(attn), self.dropout_rate, self.training, generator)
        attn = torch.softmax(attn.float(), dim=1).to(v.dtype).transpose(1, 2)   # (B, H, L)
        B, L, E = v.shape
        H = self.nhead
        gated = attn.reshape(B * H, L, 1) * v.reshape(B * H, L, E // H)
        return gated.reshape(B, L, E)
