"""The (data, model) grid of ranks (port of ``druglamp_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh, the model
axis innermost, and lets XLA put every collective into one program.  Here
each rank is a process with its own card and its own copy of the
parameters, and the collectives are explicit (NCCL on cards, gloo on the
CPU).  ``make_mesh(M)`` lays the N ranks out as the JAX mesh does: rank
r = d·M + m is data rank d and model rank m, so the M ranks of a **model
group** (one d) are consecutive, and the N/M ranks of a **data group** (one
m) hold the same parameter shards.

The data axis (every collective below runs over this rank's data group):

- ``MeshContext.shard_batch`` keeps data rank d's contiguous rows
  ``[d·B/D, (d+1)·B/D)`` of every leaf (a leaf whose leading dimension does
  not divide by D whole, as JAX replicates it), so the data ranks hold the
  single program's batch in its order and the M ranks of a model group the
  same rows;
- ``all_reduce_grads`` averages the gradient lists over the data ranks in
  flat f32 buckets, after which every rank of a data group applies the
  same update;
- ``all_reduce_sum`` (its backward an all-reduce of the gradient) carries
  the global BatchNorm statistics and the MLM count, and ``gather_rows``
  (its backward the rank's own slice times D: every rank computes the same
  function of the gathered rows) the global cross-modality mining.

``replicas(ctx)`` is the context a train step runs its forward and backward
under: inside it ``current()`` is the context, and the layers read it
(``nn/layers.py``'s BatchNorm, ``models/ssl.py``'s MLM, ``models/cm.py``).

The model axis (Megatron tensor parallelism; the JAX package's
``_TP_RULES``).  ``shard_params`` cuts a model built whole, as the same seed
builds it on every rank, into this model rank's pieces, module by module
(``_TP_RULES``): the up-projections column-parallel (whole output columns;
for attention, whole heads), the down-projections row-parallel, one
``copy_to_model`` (identity forward, all-reduce of the gradient backward)
before each sharded module, so every replicated parameter upstream gets its
full gradient on every model rank, and one ``reduce_from_model`` (all-reduce
forward, identity backward) after each row-parallel product, its partial
products summed in f32 and its bias added once after the sum
(``nn/layers.py::Dense``).  A module whose split does not divide by M stays
replicated whole (JAX falls back leaf by leaf, since XLA keeps any placement
correct; explicit collectives need a whole Megatron pair on one side).

The paired blocks (PMMA blocks 0–1) are not of the Megatron shape: their
heads feed ``fc`` (2E→E) on ``[self heads | guided heads]`` and ``fc``
feeds ``out``.  JAX shards ``out`` by rows and leaves ``fc`` replicated; here
``fc`` is row-parallel over the rows of this rank's heads in both halves
(rows ``[m·E/M, (m+1)·E/M)`` and ``E + [m·E/M, (m+1)·E/M)``, ``HALVES``),
followed by one reduce, and ``out`` is replicated.  Both compute the same
function.  ``gather_params`` rebuilds the whole parameters (for the tests
and for a checkpoint); ``shard_state`` cuts the AdamW moments alike.  The
CLI, as the JAX CLI, never shards: its model axis only makes the data axis
N/M wide, and the M ranks of a group compute the same rows.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from druglamp_tpu_torch.train.state import FlatAdamW

BUCKET_ELEMENTS = 1 << 23          # f32 elements of one gradient all-reduce (32 MiB)

# How a sharded tensor splits over the model axis (torch's (out, in) weights):
COLUMN = "column"     # dim 0: output columns (weights, biases, feature vectors)
ROW = "row"           # dim 1: input rows
HALVES = "halves"     # dim 1 of [first half | second half], each half by rows

# (module path, module class, what must divide by M, {its parameter or buffer:
# how it splits}); the port's names of druglamp_tpu/parallel/mesh.py::_TP_RULES,
# the paired blocks laid out as the module docstring says.
_QKV = {f"{p}{s}.{w}": COLUMN for p in ("query", "key", "value") for s in ("", "_mol")
        for w in ("weight", "bias")}
_TP_RULES = (
    (r"(^|\.)ffn(_mol)?$", "Mlp", "fc1.out_features",
     {"fc1.weight": COLUMN, "fc1.bias": COLUMN, "fc2.weight": ROW}),
    (r"(^|\.)mlp_classifier$", "MLPClassifier", "fc1.out_features",
     {"fc1.weight": COLUMN, "fc1.bias": COLUMN, "bn1.weight": COLUMN, "bn1.bias": COLUMN,
      "bn1.running_mean": COLUMN, "bn1.running_var": COLUMN, "fc2.weight": ROW}),
    (r"(^|\.)attn$", "SelfAttention", "num_heads",
     {k: v for k, v in _QKV.items() if "_mol" not in k} | {"out.weight": ROW}),
    (r"(^|\.)attn$", "PairedAttention", "num_heads",
     _QKV | {"fc.weight": HALVES, "fc_mol.weight": HALVES}),
)
# the modules whose output is a row-parallel product (reduced over the model ranks)
_REDUCED = (ROW, HALVES)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid: data rank ``rank`` of ``n_data`` in
    ``group`` (its data group; None: the default group), model rank
    ``model_rank`` of ``n_model`` in ``model_group``; ``world`` is the
    group of the whole grid (None: the default group)."""
    group: Any
    n_data: int
    rank: int
    n_model: int = 1
    model_rank: int = 0
    model_group: Any = None
    world: Any = None


def make_mesh(n_model: int = 1, group=None) -> Mesh:
    """The (data, model) grid over every rank of ``group`` (the default
    process group when one is initialized, else this process alone), the
    model axis innermost; raises when the ranks do not divide by
    ``n_model``.  Every rank must call it (it creates the groups)."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} rank(s) do not divide into a model axis of {n_model} "
                         f"(--mesh-model): start a multiple of {n_model} ranks under torchrun")
    if not dist.is_initialized():
        return Mesh(None, 1, 0)
    rank = dist.get_rank(group)
    if n_model == 1:
        return Mesh(group, world, rank, world=group)
    ranks = dist.get_process_group_ranks(group) if group is not None else list(range(world))
    n_data = world // n_model
    d, m = divmod(rank, n_model)
    data_groups = [dist.new_group([ranks[i * n_model + j] for i in range(n_data)])
                   for j in range(n_model)]
    model_groups = [dist.new_group([ranks[i * n_model + j] for j in range(n_model)])
                    for i in range(n_data)]
    return Mesh(data_groups[m], n_data, d, n_model, m, model_groups[d], group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; the backward sums the incoming
    gradients over them (each rank's loss reads the sum, so every rank's
    gradient reaches every rank's input)."""

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


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's reduce: the model ranks' partial products summed; the
    backward is the identity (each rank's partial product gets the whole
    gradient of the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Megatron's copy: the identity forward; the backward sums the model
    ranks' gradients (each holds the part that its shards of the next
    products give)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

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


def piece(t: torch.Tensor, kind: str, n: int, m: int) -> torch.Tensor:
    """Model rank m's piece of ``t`` of n (``COLUMN``, ``ROW``, ``HALVES``)."""
    if kind == COLUMN:
        return t.chunk(n, 0)[m]
    if kind == ROW:
        return t.chunk(n, 1)[m]
    first, second = t.chunk(2, 1)
    return torch.cat([first.chunk(n, 1)[m], second.chunk(n, 1)[m]], 1)


def join(pieces: Sequence[torch.Tensor], kind: str) -> torch.Tensor:
    """The whole tensor from the model ranks' pieces in rank order."""
    if kind == COLUMN:
        return torch.cat(list(pieces), 0)
    if kind == ROW:
        return torch.cat(list(pieces), 1)
    halves = [p.chunk(2, 1) for p in pieces]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves], 1)


def _attr(module, path: str):
    for name in path.split("."):
        module = getattr(module, name)
    return module


def _rule(path: str, module: torch.nn.Module, rules):
    """(what must divide, {name: how it splits}) of the rule that matches
    the module at ``path``, or None."""
    for pattern, cls, count, splits in rules:
        if type(module).__name__ == cls and re.search(pattern, path):
            return count, splits
    return None


def tp_plan(model: torch.nn.Module, n_model: int, rules=_TP_RULES
            ) -> Dict[str, Dict[str, str]]:
    """{module path: {parameter or buffer name under it: how it splits}} of
    the modules of ``model`` that ``rules`` shard over a model axis of
    ``n_model``; a module whose count (heads, hidden units) does not divide
    by ``n_model`` is left out (replicated)."""
    plan = {}
    if n_model <= 1:
        return plan
    for path, module in model.named_modules():
        rule = _rule(path, module, rules)
        if rule is not None and _attr(module, rule[0]) % n_model == 0:
            plan[path] = dict(rule[1])
    return plan


def param_spec(name: str, model: torch.nn.Module, n_model: int, rules=_TP_RULES) -> Optional[str]:
    """How the parameter or buffer ``name`` of ``model`` splits over a model
    axis of ``n_model`` (None: replicated)."""
    for path, splits in tp_plan(model, n_model, rules).items():
        prefix = f"{path}." if path else ""
        if name.startswith(prefix) and name[len(prefix):] in splits:
            return splits[name[len(prefix):]]
    return None


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
        """The data rank."""
        return self.mesh.rank

    @property
    def n_model(self) -> int:
        return self.mesh.n_model

    @property
    def model_rank(self) -> int:
        return self.mesh.model_rank

    @property
    def primary(self) -> bool:
        """The first rank of the grid (the one that writes)."""
        return self.mesh.rank == 0 and self.mesh.model_rank == 0

    def rows(self, n: int) -> slice:
        """This data rank's rows of a leading dimension ``n``; all of them
        when ``n`` does not divide by the data ranks."""
        if n % self.n_data:
            return slice(0, n)
        k = n // self.n_data
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard_batch(self, batch: Dict[str, Any], whole=()) -> Dict[str, Any]:
        """This data rank's rows of every leaf (numpy arrays or tensors,
        nested dicts); the keys in ``whole`` and 0-d leaves stay as they
        are."""
        def one(v):
            if isinstance(v, dict):
                return {k: one(x) for k, x in v.items()}
            if getattr(v, "ndim", 0) < 1:
                return v
            return v[self.rows(v.shape[0])]
        return {k: (v if k in whole else one(v)) for k, v in batch.items()}

    # --- the data axis ---------------------------------------------------------------------

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the data ranks, differentiable (module docstring)."""
        return _AllReduceSum.apply(t, self.mesh.group)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t`` in rank order (the global batch),
        for a function every rank computes alike (module docstring)."""
        return _GatherRows.apply(t, self.mesh.group, self.n_data, self.rank)

    @torch.no_grad()
    def all_reduce_grads(self, grads: Dict[str, List[torch.Tensor]]
                         ) -> Dict[str, List[torch.Tensor]]:
        """Each gradient list averaged over the data ranks: the lists'
        leaves in order, packed into flat f32 buckets of at most
        BUCKET_ELEMENTS, one all-reduce a bucket, then divided by the number
        of data ranks."""
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
    def broadcast_buffers(self, module: torch.nn.Module) -> None:
        """Data rank 0's buffers (the BatchNorm running statistics) into
        every rank of its data group, in one broadcast (a model rank keeps
        its own pieces of a sharded buffer)."""
        bufs = [b for b in module.buffers() if b.is_floating_point()]
        if not bufs:
            return
        flat = torch.cat([b.reshape(-1).float() for b in bufs])
        group = self.mesh.group
        src = dist.get_global_rank(group, 0) if group is not None else 0
        dist.broadcast(flat, src=src, group=group)
        a = 0
        for b in bufs:
            b.copy_(flat[a:a + b.numel()].view(b.shape))
            a += b.numel()

    def barrier(self) -> None:
        """Every rank of the grid waits for the others."""
        if self.n_data * self.n_model > 1:
            dist.barrier(group=self.mesh.world)

    # --- the model axis --------------------------------------------------------------------

    def model_barrier(self) -> None:
        """The ranks of this model group wait for each other."""
        if self.n_model > 1:
            dist.barrier(group=self.mesh.model_group)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's copy before a sharded module (module docstring)."""
        return _CopyToModel.apply(x, self.mesh.model_group)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's reduce after a row-parallel product (module docstring)."""
        return _ReduceFromModel.apply(x, self.mesh.model_group)

    @torch.no_grad()
    def shard_params(self, model: torch.nn.Module, rules=_TP_RULES) -> Dict[str, str]:
        """Cut ``model`` (whole, the same on every rank) into this model
        rank's pieces per ``rules`` and make its sharded modules run
        tensor-parallel (``module.tp``; a row-parallel ``Dense``'s
        ``tp_reduce``) → {parameter or buffer name: how it split}.  The
        parameters keep their identity (their data is replaced), so an
        optimizer built before still holds them; ``shard_state`` cuts its
        moments.  Initialize the whole model before: ``init_model`` on a
        sharded model would draw other weights."""
        n, m = self.n_model, self.model_rank
        done = {}
        for path, splits in tp_plan(model, n, rules).items():
            module = model.get_submodule(path)
            module.tp = self
            for name, kind in splits.items():
                owner_path, _, leaf = name.rpartition(".")
                owner = module.get_submodule(owner_path)
                t = getattr(owner, leaf)
                if isinstance(t, torch.nn.Parameter):
                    t.data = piece(t.data, kind, n, m).clone()
                else:
                    owner._buffers[leaf] = piece(t, kind, n, m).clone()
                if kind in _REDUCED:
                    owner.tp_reduce = self
                done[f"{path}.{name}" if path else name] = kind
        return done

    @torch.no_grad()
    def shard_state(self, model: torch.nn.Module, state, rules=_TP_RULES) -> Dict[str, str]:
        """``shard_params``, and each AdamW moment of ``state`` (a
        ``TrainState``) cut as its parameter → the split.  A flat AdamW's
        buffers are unraveled by the whole parameters' shapes, each leaf cut
        so, and this rank's pieces raveled again."""
        names = {id(p): name for name, p in model.named_parameters()}
        shapes = {id(p): p.shape for p in model.parameters()}
        split = self.shard_params(model, rules)
        n, m = self.n_model, self.model_rank
        for opt in (state.opt_cls, state.opt_ssl, state.opt_cm):
            if opt is None:
                continue
            if isinstance(opt, FlatAdamW):
                if opt.m.numel() == sum(p.numel() for p in opt.params):
                    continue                      # already this rank's
                kinds = [split.get(names.get(id(p))) for p in opt.params]
                sizes = [shapes[id(p)].numel() for p in opt.params]
                for key in ("m", "v"):
                    leaves = getattr(opt, key).split(sizes)
                    setattr(opt, key, torch.cat([
                        (leaf if kind is None
                         else piece(leaf.view(shapes[id(p)]), kind, n, m)).reshape(-1)
                        for leaf, kind, p in zip(leaves, kinds, opt.params)]))
                continue
            for p, st in opt.state.items():
                kind = split.get(names.get(id(p)))
                if kind is None:
                    continue
                for key in ("exp_avg", "exp_avg_sq"):
                    if key in st and st[key].shape != p.shape:
                        st[key] = piece(st[key], kind, n, m).clone()
        return split

    @torch.no_grad()
    def gather_params(self, model: torch.nn.Module, rules=_TP_RULES,
                      values: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
        """The whole ``state_dict`` of a sharded ``model``: each sharded
        parameter and buffer gathered from the model ranks and joined; with
        ``values`` ({name: tensor shaped as that parameter's piece here},
        e.g. its gradient), those tensors whole instead."""
        kinds = {}
        for path, module in model.named_modules():
            rule = _rule(path, module, rules) if getattr(module, "tp", None) else None
            if rule is not None:
                kinds.update({f"{path}.{k}" if path else k: v for k, v in rule[1].items()})
        out = {}
        for name, t in (model.state_dict() if values is None else values).items():
            kind = kinds.get(name)
            if kind is None or self.n_model == 1:
                out[name] = t.detach().clone()
                continue
            parts = [torch.empty_like(t) for _ in range(self.n_model)]
            dist.all_gather(parts, t.detach().contiguous(), group=self.mesh.model_group)
            out[name] = join(parts, kind)
        return out


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


def tp_size(tp: Optional[MeshContext]) -> Tuple[int, int]:
    """(model ranks, this rank's index) of a module's ``tp`` (1, 0 when None)."""
    return (1, 0) if tp is None else (tp.n_model, tp.model_rank)


_CURRENT: Optional[MeshContext] = None


def current() -> Optional[MeshContext]:
    """The context of the step running now, when it spans more than one data rank."""
    return _CURRENT


@contextlib.contextmanager
def replicas(ctx: Optional[MeshContext]):
    """Run the block under ``ctx`` (``current()`` returns it while it spans
    more than one data rank)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx if ctx is not None and ctx.n_data > 1 else None
    try:
        yield
    finally:
        _CURRENT = prev
