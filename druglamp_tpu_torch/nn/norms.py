"""The reference's gain-only LayerNorm (port of ``druglamp_tpu/nn/norms.py``;
reference model/basic_model.py:37-46): a gain ``g`` and no bias, the biased
variance, eps 1e-5 for f32 inputs and 1e-3 for half-precision ones,
computed in f32 and returned in the input's dtype."""

from __future__ import annotations

import torch
from torch import nn


class GainLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + eps) * self.g).to(x.dtype)

    def init_weights(self, g) -> None:
        with torch.no_grad():
            self.g.fill_(1.0)
