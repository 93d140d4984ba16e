"""Block-wise rematerialisation of the train step: the JAX package's
``DRUGLAMP_REMAT`` (``druglamp_tpu/train/steps.py::_remat_wrap``).

    DRUGLAMP_REMAT=full python -m druglamp_tpu_torch.cli.main --model DrugLAMP2C2P ...

``mode()`` reads the variable when a step is built (``train/steps.py::
_make_step_body``, so every caller of the step body: ``make_train_step``,
``make_epoch_step_gather``, the ``Trainer`` and the CLI):

- unset, ``""``, ``none`` or ``0``: the eager step; nothing is wrapped.
- ``full``: each region keeps only its inputs; the backward runs its forward
  again.
- ``dots``: each region keeps its inputs and the outputs of its matrix
  products (aten ``mm``, ``addmm``, ``bmm``, ``baddbmm``), as
  ``jax.checkpoint_policies.checkpoint_dots`` keeps those of
  ``dot_general``; everything else is recomputed, the hand-written attention
  and GCN kernels and the convolutions included (JAX recomputes its Pallas
  calls and convolutions under that policy too).
- anything else: ``ValueError``.

Remat recomputes the same operations, so every mode gives the eager step's
losses, probabilities, parameters, BatchNorm buffers and generator state
bit for bit.

**Regions.**  The JAX package checkpoints the whole forward and its losses
as one region, which ``jax.vjp`` differentiates once for three cotangents.
The port takes three ``torch.autograd.grad`` of one retained graph: each
gradient rebuilds every region it reaches, and whatever it rebuilds and does
not unpack stays until the graph is freed.  So a region here is a module
call that each gradient reaching it uses whole (``_targets``): each GCN
layer, the ProteinCNN, the two LLM adaptors, the two fusion stages
(GCA + MHLA + LayerNorm), each PMMA block, the MLP head, the SSL's MLM part
(the mask draw, the re-encode through the shared ProteinCNN and both
logits heads), each call of its drug MLPs (the two SimSiam projections and
the predictor, the largest holders of the eager step: PERF.md), and the CM
head.  A region called inside another (the ProteinCNN inside the MLM part)
runs as part of the outer one.  The regions exist only while the step's forward runs
(``Regions.forward`` sets the calls on the module instances and takes them
off again); serving and eval never see them.  Everything between regions
(site pooling, concatenations, PMMA's embeddings, the losses) is kept as the
eager step keeps it.

**What a recompute restores.**  ``torch.utils.checkpoint`` restores only
torch's default generators, so each region notes the state of every
``torch.Generator`` passed to it (the dropout and MLM draws) and a
recompute starts from it and gives the generator back as it found it.  A
recompute runs under the numerics and the ``parallel.mesh.replicas``
context that the region's forward saw (``true_f32``, cuDNN's deterministic
algorithms, the data ranks of global BatchNorm and of the SSL and CM
collectives), and under ``nn.layers.frozen_running_stats``: BatchNorm
running statistics are updated once, by the forward.  Global BatchNorm and
the model axis's row-parallel products run their collectives again in a
recompute; every rank runs the same graph, so every rank recomputes the same
regions in the same order.  Under ``dots`` the selective checkpoint hands a
saved output out once per backward; ``Regions.before_gradient`` gives each
region its saved outputs back before each of the step's gradients, as new
aliases (``_aliased``), and ``Regions.release`` drops them after the last.

Nothing falls back: a region that cannot recompute raises (the checkpoint's
own checks compare each recomputed tensor's shape, dtype and device with
the forward's), and a model without the regions raises when a mode is on.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import os
from typing import Callable, Iterator, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from druglamp_tpu_torch.nn.layers import frozen_running_stats
from druglamp_tpu_torch.parallel import mesh as dp

MODES = ("none", "dots", "full")
_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
             torch.ops.aten.baddbmm)


def mode() -> str:
    """``DRUGLAMP_REMAT`` as one of ``MODES`` (``_remat_wrap``'s reading)."""
    m = os.environ.get("DRUGLAMP_REMAT", "none").lower()
    if m in ("", "none", "0"):
        return "none"
    if m in MODES:
        return m
    raise ValueError(f"DRUGLAMP_REMAT={m!r}: expected none|dots|full")


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The ``dots`` policy: keep the matrix products' outputs."""
    if op.overloadpacket in _PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _targets(model: nn.Module) -> Iterator[Tuple[object, str]]:
    """(object, method name) of every region of a DrugLAMP model, in the
    order the step runs them."""
    gcn = model.drug_extractor
    for i in range(gcn.n_layers):
        yield getattr(gcn, f"layer_{i}"), "forward"
    yield model.protein_extractor, "forward"
    if model.uses_llm:
        yield model, "_encode_prot_llm"
        yield model, "_encode_drug_llm"
        yield model, "_fuse_x"
    yield model, "_fuse_v"
    for i in range(model.pmma.num_layers):
        yield getattr(model.pmma, f"block_{i}"), "forward"
    yield model.mlp_classifier, "forward"
    ssl = model.ssl_model
    yield ssl, "prot_mlm"
    for name in ("net", "llm_net", "predictor"):        # what the LLM stream builds
        if hasattr(ssl, name):
            yield getattr(ssl, name), "forward"
    yield model.cm_model, "forward"


def _settings() -> tuple:
    return (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision(),
            torch.backends.cudnn.deterministic, dp.current())


def _apply(settings: tuple) -> None:
    torch.backends.cudnn.allow_tf32 = settings[0]
    torch.set_float32_matmul_precision(settings[1])
    torch.backends.cudnn.deterministic = settings[2]


@contextlib.contextmanager
def _as_in_forward(settings: tuple, generators: List[torch.Generator],
                   states: List[torch.Tensor]) -> Iterator[None]:
    """A recompute's surroundings: the forward's numerics, mesh context and
    generator states, and frozen BatchNorm statistics; all given back after."""
    saved, now = _settings(), [g.get_state() for g in generators]
    _apply(settings)
    for g, s in zip(generators, states):
        g.set_state(s)
    try:
        with dp.replicas(settings[3]), frozen_running_stats():
            yield
    finally:
        _apply(saved)
        for g, s in zip(generators, now):
            g.set_state(s)


def _aliased(storage: dict) -> dict:
    """A copy of a selective checkpoint's saved outputs ({op: list, or
    {index: entry}}) whose tensors are new aliases (``detach``) of the same
    memory.  A recompute hands its saved outputs to autograd, which gives
    them the recompute's history; a gradient that got them as they were
    would keep the previous gradient's recomputed graph alive through them,
    and past the step, since that graph leads back to the regions' frames
    and so to their saved outputs."""
    def entry(e):
        if isinstance(e, (tuple, list)):
            return type(e)(entry(x) for x in e)
        if isinstance(getattr(e, "val", None), torch.Tensor):   # the checkpoint's version wrapper
            e = copy.copy(e)
            e.val = e.val.detach()
        return e

    return {k: ({i: entry(e) for i, e in v.items()} if isinstance(v, dict)
                else [entry(e) for e in v]) for k, v in storage.items()}


class Regions:
    """One step's regions over ``model`` in ``mode`` (one of ``MODES``; under
    ``none`` there are none and every call does nothing):
    ``with regions.forward():`` around the forward and the losses,
    ``regions.before_gradient()`` before each ``torch.autograd.grad`` and
    ``regions.release()`` after the last."""

    def __init__(self, model: nn.Module, mode: str):
        if mode not in MODES:
            raise ValueError(f"remat mode {mode!r}: expected one of {MODES}")
        try:
            self._targets = list(_targets(model)) if mode != "none" else []
        except AttributeError as e:
            raise ValueError(f"DRUGLAMP_REMAT={mode}: {type(model).__name__} has no remat "
                             f"regions ({e})") from None
        self._context_fn = self._products_context if mode == "dots" else None
        self._storages: List[dict] = []     # each dots region's saved outputs, as it fills them
        self._saved: List[dict] = []        # ... and a copy, taken when the forward ends
        self._depth = 0

    @contextlib.contextmanager
    def forward(self) -> Iterator[None]:
        """Every region's call is checkpointed inside the block."""
        for obj, name in self._targets:
            setattr(obj, name, self._region(getattr(obj, name)))
        try:
            yield
        finally:
            for obj, name in self._targets:
                delattr(obj, name)       # the class's method again
        self._saved = [_aliased(s) for s in self._storages]

    def before_gradient(self) -> None:
        """Give each ``dots`` region its saved outputs back (a selective
        checkpoint hands each out once), as new aliases."""
        for storage, saved in zip(self._storages, self._saved):
            storage.clear()
            storage.update(_aliased(saved))

    def release(self) -> None:
        """Drop the saved outputs once the step's last gradient is taken."""
        for storage in self._storages:
            storage.clear()
        self._saved = []

    def _products_context(self):
        fwd, recompute = create_selective_checkpoint_contexts(_save_products)
        self._storages.append(fwd.storage)
        return fwd, recompute

    @contextlib.contextmanager
    def _inside(self) -> Iterator[None]:
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def _region(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if self._depth:           # inside another region: part of it
                return fn(*args, **kwargs)
            generators = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Generator)]
            states = [g.get_state() for g in generators]
            settings = _settings()
            ran = False

            def body(*a, **kw):       # the forward, then each recompute
                nonlocal ran
                again, ran = ran, True
                with (_as_in_forward(settings, generators, states) if again
                      else contextlib.nullcontext()), self._inside():
                    return fn(*a, **kw)

            extra = {} if self._context_fn is None else {"context_fn": self._context_fn}
            return checkpoint(body, *args, use_reentrant=False, **extra, **kwargs)

        return call
