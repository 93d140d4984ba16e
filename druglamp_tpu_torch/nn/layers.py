"""Primitive layers with the reference's (flax) dtype and BatchNorm semantics."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from druglamp_tpu_torch.nn import inits


class Dense(nn.Linear):
    """``y = x Wᵀ + b`` with the reference's dtype rule.

    ``dtype`` set: input, weight and bias are cast to it and the result has it
    (flax ``TorchDense(dtype=...)`` / ``nn.Dense(dtype=...)``).  ``dtype=None``:
    the operands promote, so a bf16 ``x`` times the f32 weight computes and
    returns f32 (``druglamp_tpu/nn/layers.py:25``).

    ``init``: ``"torch"`` is torch.nn.Linear's default (U(±1/√fan_in) weight and
    bias); ``"xavier"`` is the PMMA MLP's xavier-uniform weight with an
    N(0, 1e-6) bias.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, init: str = "torch"):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.init = init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        if self.init == "xavier":
            inits.xavier_uniform_(self.weight, g)
            if self.bias is not None:
                inits.normal_(self.bias, 1e-6, g)
        else:
            inits.torch_linear_(self.weight, g)
            if self.bias is not None:
                inits.uniform_(self.bias, inits.fan_in_bound(self.in_features), g)


def _check_groups(groups: int) -> None:
    if groups != 1:
        raise NotImplementedError("BatchNorm with per-replica statistics (groups > 1) belongs "
                                  "to the multi-GPU slice")


class TorchBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, in f32 (flax ``nn.BatchNorm`` as
    ``druglamp_tpu/nn/layers.py::TorchBatchNorm`` configures it, groups=1).

    Eval normalizes with the running stats.  Train normalizes with the biased
    batch variance and updates the running stats as flax does:
    ``ra = 0.9·ra + 0.1·batch`` with the *biased* variance.  Returns f32 (flax
    promotes a bf16 input with the f32 scale/bias).  ``affine=False`` has no
    scale and bias (SimSiam's last BatchNorm).
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, groups: int = 1):
        super().__init__()
        _check_groups(groups)
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        xf = x.reshape(-1, shape[-1]).float()
        if self.training:
            mean = xf.mean(0)
            var = xf.var(0, unbiased=False)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        if self.affine:
            y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        else:
            y = (xf - mean) * torch.rsqrt(var + self.eps)
        return y.reshape(shape)

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            if self.affine:
                self.weight.fill_(1.0)
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over (N, C) whose statistics come from the rows where
    ``mask`` is set (``druglamp_tpu/nn/layers.py::MaskedBatchNorm``, groups=1):
    the cross-modality head normalizes the unique-entity rows of a fixed-size
    batch.  Train: mean and biased variance over the valid rows (n =
    max(#valid, 1)); running stats ``0.9·ra + 0.1·batch`` with the *unbiased*
    variance (torch's convention).  Computed and returned in f32."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True,
                 groups: int = 1):
        super().__init__()
        _check_groups(groups)
        self.eps = eps
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            m = mask.float()[:, None]
            n = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(0) / n
            var = (((xf - mean) ** 2) * m).sum(0) / n
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                self.running_var.copy_(0.9 * self.running_var + 0.1 * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight + self.bias
        return y

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            if self.affine:
                self.weight.fill_(1.0)
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in f32 (flax promotes a bf16 input with
    the f32 scale/bias)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        self.reset_parameters()


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: in training, keep each entry with probability
    1 − rate and scale the kept ones by 1/(1 − rate) in x's dtype; otherwise
    the identity.  The mask is drawn from ``generator`` (on x's device), so
    two runs from one seed drop the same entries; ``None`` takes torch's
    default generator."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=generator)
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def matmul_f32(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` on operands rounded to ``dtype``, accumulated and returned in
    f32 (JAX's ``preferred_element_type=jnp.float32``)."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())
