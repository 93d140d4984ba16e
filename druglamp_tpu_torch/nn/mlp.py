"""MLP heads and adaptors (port of ``druglamp_tpu/nn/mlp.py``)."""

from __future__ import annotations

import torch
from torch import nn

from druglamp_tpu_torch.nn.layers import Dense, LayerNorm, TorchBatchNorm, gelu


class FeedForwardLayer(nn.Module):
    """lin1(d_in→d_h) → GELU → LayerNorm(d_h) → lin2(d_h→d_in)."""

    def __init__(self, d_in: int, d_h: int):
        super().__init__()
        self.lin1 = Dense(d_in, d_h)
        self.norm = LayerNorm(d_h, eps=1e-5)
        self.lin2 = Dense(d_h, d_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.norm(gelu(self.lin1(x))))


class MLPClassifier(nn.Module):
    """in→hidden→hidden→out→binary with GELU + BatchNorm per hidden layer."""

    def __init__(self, in_dim: int = 512, hidden_dim: int = 1024, out_dim: int = 256,
                 binary: int = 1):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim)
        self.bn1 = TorchBatchNorm(hidden_dim)
        self.fc2 = Dense(hidden_dim, hidden_dim)
        self.bn2 = TorchBatchNorm(hidden_dim)
        self.fc3 = Dense(hidden_dim, out_dim)
        self.bn3 = TorchBatchNorm(out_dim)
        self.fc4 = Dense(out_dim, binary)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1(gelu(self.fc1(x)))
        x = self.bn2(gelu(self.fc2(x)))
        x = self.bn3(gelu(self.fc3(x)))
        return self.fc4(x)
