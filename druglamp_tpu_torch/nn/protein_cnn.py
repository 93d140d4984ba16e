"""Protein CNN encoder (port of ``druglamp_tpu/nn/protein_cnn.py``).

Embedding(27 → embedding_dim-1, pad id 0 pinned to zeros) ‖ fill-bit, then
3 × [Conv1d 'same' → ReLU → BatchNorm (f32)].  Public layout is (B, L, C).
The reference's one-hot matmul gives a zero row for an id outside the
vocabulary; the gather here masks those ids to the same zero row.  'same'
padding is asymmetric for even kernels (left (k-1)//2, right k//2), so k=6
matches torch and the reference.  The forward's f32 convolutions run in
true f32 whatever torch's TF32 settings (cuDNN's default is TF32;
``utils/numerics.py``); the train steps run the backward in true f32 too.
The embedding's weight gradient is the product one_hot(ids)ᵀ · grad, the
gradient of the reference's one-hot matmul: ``F.embedding``'s own backward
sums on a card with atomics in an order that changes from run to run.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from druglamp_tpu_torch.nn import inits
from druglamp_tpu_torch.nn.layers import TorchBatchNorm
from druglamp_tpu_torch.utils.numerics import true_f32


class _OneHotEmbedding(torch.autograd.Function):
    """``F.embedding(ids, weight)`` whose weight gradient is one_hot(ids)ᵀ ·
    grad, a matrix product that sums in a fixed order."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.vocab = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        onehot = F.one_hot(ids.reshape(-1), ctx.vocab).to(grad.dtype)
        return None, onehot.t() @ grad.reshape(-1, grad.shape[-1])


class ProteinCNN(nn.Module):
    def __init__(self, embedding_dim: int = 128, num_filters: Sequence[int] = (128, 128, 128),
                 kernel_size: Sequence[int] = (3, 6, 9), padding: bool = True,
                 vocab: int = 27, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.padding = padding
        self.vocab = vocab
        self.compute_dtype = dtype
        self.kernel_size = tuple(kernel_size)
        self.embedding = nn.Embedding(vocab, embedding_dim - 1)
        in_ch = embedding_dim
        for i, (filters, k) in enumerate(zip(num_filters, kernel_size)):
            self.add_module(f"conv{i + 1}", nn.Conv1d(in_ch, filters, k))
            self.add_module(f"bn{i + 1}", TorchBatchNorm(filters))
            in_ch = filters

    def forward(self, v: torch.Tensor, fill_mask: torch.Tensor) -> torch.Tensor:
        """v (B, L) int tokens, fill_mask (B, L) float → (B, L, num_filters[-1])."""
        keep = (v >= 0) & (v < self.vocab)
        if self.padding:
            keep = keep & (v != 0)          # torch padding_idx=0: row 0 is zeros
        x = _OneHotEmbedding.apply(v.long().clamp(0, self.vocab - 1), self.embedding.weight)
        x = x * keep[..., None].to(x.dtype)
        x = torch.cat([x, fill_mask[..., None].to(x.dtype)], dim=-1)

        cd = self.compute_dtype or x.dtype
        x = x.to(cd)
        with true_f32():
            for i, k in enumerate(self.kernel_size):
                conv = getattr(self, f"conv{i + 1}")
                xt = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
                y = F.relu(F.conv1d(xt, conv.weight.to(cd), conv.bias.to(cd)))
                x = getattr(self, f"bn{i + 1}")(y.transpose(1, 2)).to(cd)
        return x

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        inits.normal_(self.embedding.weight, 1.0, g)
        for i, k in enumerate(self.kernel_size):
            conv = getattr(self, f"conv{i + 1}")
            inits.torch_linear_(conv.weight, g)
            inits.uniform_(conv.bias, inits.fan_in_bound(conv.in_channels * k), g)
