"""Data parallelism over the ranks of a process group (port of
``druglamp_tpu/parallel/mesh.py``'s ``data`` axis).

The JAX package shards each batch over a ``data`` mesh axis and lets XLA put
the gradient collectives into one program.  Here each rank is a process
with its own card and its own copy of the parameters, and the collectives
are explicit (NCCL on cards, gloo on the CPU):

- ``MeshContext.shard_batch`` keeps rank r's contiguous rows
  ``[r·B/N, (r+1)·B/N)`` of every leaf (a leaf whose leading dimension does
  not divide by N whole, as JAX replicates it), so the ranks hold the
  single program's batch in its order;
- ``all_reduce_grads`` averages the gradient lists over the ranks in flat
  f32 buckets, after which every rank applies the same update and the
  parameters stay bit-identical;
- ``all_reduce_sum`` (its backward an all-reduce of the gradient) carries
  the global BatchNorm statistics, and ``gather_rows`` (its backward the
  rank's own slice times N: every rank computes the same function of the
  gathered rows) the global cross-modality mining.

``replicas(ctx)`` is the context a train step runs its forward and backward
under: inside it ``current()`` is the context, and the layers read it
(``nn/layers.py``'s BatchNorm, ``models/ssl.py``'s MLM, ``models/cm.py``).
Tensor parallelism (a ``model`` axis) belongs to the tensor-parallel slice.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from druglamp_tpu_torch.parallel import TENSOR_PARALLEL_SLICE

BUCKET_ELEMENTS = 1 << 23          # f32 elements of one gradient all-reduce (32 MiB)


@dataclass(frozen=True)
class Mesh:
    """The data axis: ``n_data`` ranks of ``group`` (None: the default group),
    this process at ``rank``."""
    group: Any
    n_data: int
    rank: int


def make_mesh(n_model: int = 1, group=None) -> Mesh:
    """The data axis over every rank of ``group`` (the default process group
    when one is initialized, else this process alone)."""
    if n_model > 1:
        raise NotImplementedError(f"a model axis of {n_model} (tensor parallelism, --mesh-model)"
                                  f" belongs to {TENSOR_PARALLEL_SLICE}")
    if not dist.is_initialized():
        return Mesh(None, 1, 0)
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradients over the
    ranks (each rank's loss reads the sum, so every rank's gradient reaches
    every rank's input)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone().contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherRows(torch.autograd.Function):
    """The ranks' row blocks concatenated in rank order.  Every rank computes
    the same function of the result, so the gradient of the rank's own
    block summed over the ranks is N times its slice of the gradient here:
    the backward returns that, with no collective."""

    @staticmethod
    def forward(ctx, t, group, n_data, rank):
        ctx.n_data, ctx.rank, ctx.rows = n_data, rank, t.shape[0]
        parts = [torch.empty_like(t) for _ in range(n_data)]
        dist.all_gather(parts, t.detach().contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        a = ctx.rank * ctx.rows
        return grad[a:a + ctx.rows] * ctx.n_data, None, None, None


class MeshContext:
    """Shard, gather and reduce helpers over a ``Mesh`` for the steps and the
    trainer.  With one rank every helper is the identity."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh(1)

    @property
    def n_data(self) -> int:
        return self.mesh.n_data

    @property
    def rank(self) -> int:
        return self.mesh.rank

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading dimension ``n``; all of them when
        ``n`` does not divide by the ranks."""
        if n % self.n_data:
            return slice(0, n)
        k = n // self.n_data
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard_batch(self, batch: Dict[str, Any], whole=()) -> Dict[str, Any]:
        """This rank's rows of every leaf (numpy arrays or tensors, nested
        dicts); the keys in ``whole`` and 0-d leaves stay as they are."""
        def one(v):
            if isinstance(v, dict):
                return {k: one(x) for k, x in v.items()}
            if getattr(v, "ndim", 0) < 1:
                return v
            return v[self.rows(v.shape[0])]
        return {k: (v if k in whole else one(v)) for k, v in batch.items()}

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks, differentiable (module docstring)."""
        return _AllReduceSum.apply(t, self.mesh.group)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t`` in rank order (the global batch), for a
        function every rank computes alike (module docstring)."""
        return _GatherRows.apply(t, self.mesh.group, self.n_data, self.rank)

    @torch.no_grad()
    def all_reduce_grads(self, grads: Dict[str, List[torch.Tensor]]
                         ) -> Dict[str, List[torch.Tensor]]:
        """Each gradient list averaged over the ranks: the lists' leaves in
        order, packed into flat f32 buckets of at most BUCKET_ELEMENTS, one
        all-reduce a bucket, then divided by the number of ranks."""
        leaves = [(name, i, g) for name, gs in grads.items() for i, g in enumerate(gs)]
        out = {name: list(gs) for name, gs in grads.items()}
        for bucket in _buckets(leaves):
            flat = torch.cat([g.reshape(-1).float() for _, _, g in bucket])
            dist.all_reduce(flat, group=self.mesh.group)
            flat /= self.n_data
            a = 0
            for name, i, g in bucket:
                out[name][i] = flat[a:a + g.numel()].view(g.shape).to(g.dtype)
                a += g.numel()
        return out

    @torch.no_grad()
    def broadcast_buffers(self, module: torch.nn.Module, src: int = 0) -> None:
        """Rank ``src``'s buffers (the BatchNorm running statistics) into
        every rank's ``module``, in one broadcast."""
        bufs = [b for b in module.buffers() if b.is_floating_point()]
        if not bufs:
            return
        flat = torch.cat([b.reshape(-1).float() for b in bufs])
        dist.broadcast(flat, src=src, group=self.mesh.group)
        a = 0
        for b in bufs:
            b.copy_(flat[a:a + b.numel()].view(b.shape))
            a += b.numel()

    def barrier(self) -> None:
        if self.n_data > 1:
            dist.barrier(group=self.mesh.group)


def _buckets(leaves) -> Iterator[list]:
    bucket, n = [], 0
    for leaf in leaves:
        if bucket and n + leaf[2].numel() > BUCKET_ELEMENTS:
            yield bucket
            bucket, n = [], 0
        bucket.append(leaf)
        n += leaf[2].numel()
    if bucket:
        yield bucket


_CURRENT: Optional[MeshContext] = None


def current() -> Optional[MeshContext]:
    """The context of the step running now, when it spans more than one rank."""
    return _CURRENT


@contextlib.contextmanager
def replicas(ctx: Optional[MeshContext]):
    """Run the block under ``ctx`` (``current()`` returns it while it spans
    more than one rank)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx if ctx is not None and ctx.n_data > 1 else None
    try:
        yield
    finally:
        _CURRENT = prev
