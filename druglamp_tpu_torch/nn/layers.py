"""Primitive layers with the reference's (flax) dtype and BatchNorm semantics."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from druglamp_tpu_torch.nn import inits
from druglamp_tpu_torch.parallel import mesh as dp


class Dense(nn.Linear):
    """``y = x Wᵀ + b`` with the reference's dtype rule.

    ``dtype`` set: input, weight and bias are cast to it and the result has it
    (flax ``TorchDense(dtype=...)`` / ``nn.Dense(dtype=...)``).  ``dtype=None``:
    the operands promote, so a bf16 ``x`` times the f32 weight computes and
    returns f32 (``druglamp_tpu/nn/layers.py:25``).

    ``init``: ``"torch"`` is torch.nn.Linear's default (U(±1/√fan_in) weight and
    bias); ``"xavier"`` is the PMMA MLP's xavier-uniform weight with an
    N(0, 1e-6) bias.

    Row-parallel (``tp_reduce``, a ``MeshContext`` that
    ``MeshContext.shard_params`` sets): the weight holds this model rank's
    input rows; the partial product is accumulated in f32 from operands
    rounded to the compute dtype and returned in f32 (``partial_product``),
    summed over the model ranks in f32 (``reduce_from_model``), the whole
    bias added once after the sum, and the result rounded to the compute
    dtype once, as the unsharded product rounds it.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, init: str = "torch"):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.init = init
        self.tp_reduce: Optional[dp.MeshContext] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        if self.tp_reduce is None:
            return F.linear(x.to(dt), self.weight.to(dt), b)
        y = self.tp_reduce.reduce_from_model(partial_product(x.to(dt), self.weight.to(dt)))
        return (y if b is None else y + b.float()).to(dt)

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        if self.init == "xavier":
            inits.xavier_uniform_(self.weight, g)
            if self.bias is not None:
                inits.normal_(self.bias, 1e-6, g)
        else:
            inits.torch_linear_(self.weight, g)
            if self.bias is not None:
                inits.uniform_(self.bias, inits.fan_in_bound(self.in_features), g)


def _local_groups(groups: int):
    """(statistics groups in this rank's rows, the context whose ranks share
    one set of statistics or None).  ``groups > 1`` splits the global batch
    into that many contiguous blocks, each with its own statistics (torch
    DDP's per-replica BatchNorm); with N ranks each rank holds groups/N of
    them.  ``groups == 1`` under a step over several ranks: one set of
    statistics over every rank's rows (``parallel.mesh.current()``)."""
    ctx = dp.current()
    if groups > 1:
        world = ctx.n_data if ctx is not None else 1
        if groups % world:
            raise ValueError(f"{groups} BatchNorm groups do not divide over {world} ranks")
        return groups // world, None
    return 1, ctx


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype every BatchNorm's statistics accumulate in: f64 on a card,
    where f32 column sums over tens of thousands of rows (the ProteinCNN's
    B·2304) lose enough that channels of small variance move the gradients
    beyond the step tolerances (PERF.md, the data-parallel findings); f32 on
    the CPU, as the JAX package's, which the CPU parity tests hold the port
    to bit-closely.  ``tests/test_torch_port_parallel.py`` holds the f64
    path to the JAX step as well."""
    return torch.float64 if x.is_cuda else torch.float32


def _moments(x: torch.Tensor, dim: int):
    """Mean and biased variance along ``dim`` (accumulated in ``_acc_dtype``),
    in f32."""
    xa = x.to(_acc_dtype(x))
    return xa.mean(dim).float(), xa.var(dim, unbiased=False).float()


def _global_moments(xf: torch.Tensor, ctx: dp.MeshContext):
    """Mean and biased variance of the rows of (n, C) ``xf`` over every rank:
    each rank's count, mean and sum of squared deviations (in ``_acc_dtype``),
    all-reduced as one (N, 2C+1) table (``all_reduce_sum``: the gradient
    reaches every rank's rows) and merged in rank order (Chan's parallel
    variance), so every rank computes the same statistics."""
    xa = xf.to(_acc_dtype(xf))
    mean = xa.mean(0)
    row = torch.cat([xa.new_full((1,), float(xf.shape[0])), mean, ((xa - mean) ** 2).sum(0)])
    zeros = row.new_zeros
    table = ctx.all_reduce_sum(torch.cat([zeros((ctx.rank, row.numel())), row[None],
                                          zeros((ctx.n_data - ctx.rank - 1, row.numel()))]))
    C = xf.shape[1]
    counts, means, m2 = table[:, :1], table[:, 1:C + 1], table[:, C + 1:]
    total = counts.sum()
    g_mean = (counts * means).sum(0) / total
    g_var = (m2.sum(0) + (counts * (means - g_mean) ** 2).sum(0)) / total
    return g_mean.float(), g_var.float()


_STATS_FROZEN = False


@contextlib.contextmanager
def frozen_running_stats() -> Iterator[None]:
    """Inside the block, train-mode BatchNorm normalizes by its batch
    statistics as always but leaves its running statistics as they are: a
    forward that remat runs again in the backward (``train/remat.py``) must
    not update them a second time."""
    global _STATS_FROZEN
    prev, _STATS_FROZEN = _STATS_FROZEN, True
    try:
        yield
    finally:
        _STATS_FROZEN = prev


class TorchBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, in f32 (flax ``nn.BatchNorm`` as
    ``druglamp_tpu/nn/layers.py::TorchBatchNorm`` configures it).

    Eval normalizes with the running stats.  Train normalizes with the biased
    batch variance (on a card accumulated in f64, ``_moments``) and
    updates the running stats as flax does:
    ``ra = 0.9·ra + 0.1·batch`` with the *biased* variance; in a step over
    several ranks the statistics are those of every rank's rows
    (``_global_moments``).  ``groups > 1`` (``_GroupedBatchNorm``): each of
    ``groups`` contiguous blocks of the leading axis normalizes by its own
    statistics, and the running stats follow block 0 with torch's *unbiased*
    variance (the rank-0 module torch DDP checkpoints); over N ranks each
    rank holds groups/N blocks.  Returns f32 (flax promotes a bf16 input
    with the f32 scale/bias).  ``affine=False`` has no scale and bias
    (SimSiam's last BatchNorm).
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, groups: int = 1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.groups = groups
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if _STATS_FROZEN:
            return
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        xf = x.reshape(-1, shape[-1]).float()
        if self.groups > 1:
            return self._grouped(xf).reshape(shape)
        if self.training:
            _, ctx = _local_groups(1)
            if ctx is None:
                mean, var = _moments(xf, 0)
            else:
                mean, var = _global_moments(xf, ctx)
            self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        if self.affine:
            y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        else:
            y = (xf - mean) * torch.rsqrt(var + self.eps)
        return y.reshape(shape)

    def _grouped(self, xf: torch.Tensor) -> torch.Tensor:
        """``druglamp_tpu/nn/layers.py::_GroupedBatchNorm`` on (rows, C)."""
        if self.training:
            g, _ = _local_groups(self.groups)
            if xf.shape[0] % g:
                raise ValueError(f"{xf.shape[0]} rows do not split into {g} BatchNorm groups")
            xg = xf.reshape(g, -1, xf.shape[1])
            mean, var = _moments(xg, 1)
            y = ((xg - mean[:, None]) * torch.rsqrt(var[:, None] + self.eps)).reshape(xf.shape)
            n = float(xg.shape[1])
            self._update(mean[0], var[0] * n / max(n - 1.0, 1.0))
        else:
            y = (xf - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias if self.affine else y

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            if self.affine:
                self.weight.fill_(1.0)
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over (N, C) whose statistics come from the rows where
    ``mask`` is set (``druglamp_tpu/nn/layers.py::MaskedBatchNorm``): the
    cross-modality head normalizes the unique-entity rows of a fixed-size
    batch.  Train: mean and biased variance over the valid rows (n =
    max(#valid, 1)); running stats ``0.9·ra + 0.1·batch`` with the *unbiased*
    variance (torch's convention).  ``groups > 1``: per-block statistics
    over contiguous blocks of the rows, running stats from block 0 (over N
    ranks each holds groups/N blocks).  Its rows are whatever the caller
    passes: in a step over several ranks the cross-modality head gathers
    the global batch's rows first (``models/cm.py``), so nothing is reduced
    here.  Statistics accumulated in ``_acc_dtype``; returned in f32."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True,
                 groups: int = 1):
        super().__init__()
        self.eps = eps
        self.affine = affine
        self.groups = groups
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            g = _local_groups(self.groups)[0] if self.groups > 1 else 1
            if xf.shape[0] % g:
                raise ValueError(f"{xf.shape[0]} rows do not split into {g} BatchNorm groups")
            xg = xf.reshape(g, -1, xf.shape[1])
            xa = xg.to(_acc_dtype(xf))
            m = mask.to(xa.dtype).reshape(g, -1, 1)
            n = torch.clamp(m.sum(1), min=1.0)                      # (g, 1)
            mean = (xa * m).sum(1) / n                              # (g, C)
            var = (((xa - mean[:, None]) ** 2) * m).sum(1) / n
            n, mean, var = n.float(), mean.float(), var.float()
            if not _STATS_FROZEN:
                with torch.no_grad():
                    unbiased = var[0] * n[0] / torch.clamp(n[0] - 1.0, min=1.0)
                    self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean[0])
                    self.running_var.copy_(0.9 * self.running_var + 0.1 * unbiased)
            y = ((xg - mean[:, None]) * torch.rsqrt(var[:, None] + self.eps)).reshape(xf.shape)
        else:
            y = (xf - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
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
            generator: Optional[torch.Generator] = None,
            shard: Tuple[int, int] = (1, 0)) -> torch.Tensor:
    """flax ``nn.Dropout``: in training, keep each entry with probability
    1 − rate and scale the kept ones by 1/(1 − rate) in x's dtype; otherwise
    the identity.  The mask is drawn from ``generator`` (on x's device), so
    two runs from one seed drop the same entries; ``None`` takes torch's
    default generator.  ``shard`` (n, m): ``x`` is piece m of n of a tensor
    split on its last axis (a column-parallel product's output): the whole
    tensor's mask is drawn and piece m kept, so the sharded step drops what
    the unsharded one drops and the generator advances alike."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    n, m = shard
    w = x.shape[-1]
    mask = torch.empty(x.shape[:-1] + (w * n,), device=x.device).bernoulli_(
        keep, generator=generator)[..., m * w:(m + 1) * w]
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def matmul_f32(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` on operands rounded to ``dtype``, accumulated and returned in
    f32 (JAX's ``preferred_element_type=jnp.float32``)."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


class _HalfGemmF32(torch.autograd.Function):
    """``x @ wᵀ`` of bf16 or f16 operands on a card as one tensor-core GEMM
    with f32 accumulation and an f32 result (``torch.mm(..., out_dtype=)``,
    which has no autograd formula).  The backward rounds the incoming
    gradient to the operands' dtype (a row-parallel product's gradient
    arrives from a cast of its f32 result to that dtype, so the rounding is
    exact) and takes both gradients in it, as ``F.linear`` in that dtype
    does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w if ctx.needs_input_grad[0] else None
        gw = (g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ wᵀ`` of operands of one dtype, accumulated and returned in f32: a
    bf16 or f16 product on a card stays on the tensor cores
    (``_HalfGemmF32``); elsewhere the operands are widened to f32
    (``matmul_f32``), the same sums in another order."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        return _HalfGemmF32.apply(x, w)
    return matmul_f32(x, w.t(), x.dtype)
