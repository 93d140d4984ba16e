"""Train and eval steps (port of ``druglamp_tpu/train/steps.py``:
``_make_step_body`` with every gate, ``make_train_step``, ``make_eval_step``,
and the device-resident-dataset drivers ``make_epoch_step_gather`` and
``make_eval_scan_gather``).

    step = make_train_step(model, use_ssl=True, use_cm=True, calibrate=True)  # model to cuda
    state = TrainState.create(model, use_ssl=True, use_cm=True)
    out = step(state, batch, generator, lr_cls, lr_ssl, lr_cm, margin, cm_weight)
    # out.cls_loss, out.ssl_loss, out.cm_loss, out.probs, out.cm_weight (device tensors)

    epoch = make_epoch_step_gather(model, True, True, include_llm=True, emb_ordinals=True)
    out = epoch(state, idx, valid, data_tree, emb_store, generator, lr_cls, lr_ssl, lr_cm,
                margin, cm_weight)                 # out.cls_losses (S,), out.cm_weight
    probs, losses = make_eval_scan_gather(model, True, True)(idx, valid, data_tree, emb_store)

Every builder moves the model to ``device`` (``cuda`` unless the caller asks
for ``cpu``; it raises if ``cuda`` is asked for and absent).

One step (``_make_step_body``): ``decode_batch`` (a compact batch is expanded
on the device; its adjacency stays packed where ``kernels.gcn.use_packed_gcn``
says so) → one shared train-mode forward (BatchNorm uses batch statistics
and updates its running stats in place, as flax's ``mutable=["batch_stats"]``;
dropout masks come from ``generator``) → the cls loss (mean over all rows),
then with ``use_ssl`` the SSL loss (the MLM mask drawn next from
``generator``; the re-encode through the shared ProteinCNN updates its
running stats a second time), then with ``use_cm`` the raw CM loss over the
batch's ``cm`` ground truth at ``margin``.  With ``calibrate`` the CM weight
is recalibrated to a power of 10 on the device (``_calibrate``).  One
gradient per active loss, each taken at the parameters before any update
(``loss_gradients``); the CM gradient is scaled by the weight.  Then the
optimizers apply in order cls → ssl → cm, each its own gradient
(``per_loss``), or each the last computed loss's gradient
(``legacy_aliased``: the reference's optimizers with torch 1.x
``zero_grad(set_to_none=False)``); a parameter that a loss does not reach
gets a zero gradient and still decays.  All of it runs under
``utils.numerics.train_numerics()``: f32 products in true f32 (no TF32) and
cuDNN's deterministic algorithms, so two runs from one seed give
bit-identical parameters; the caller's settings are back after each step.
On a CUDA model the PMMA attention and the packed GCN run through their
hand-written kernels, forward and backward: the attention backwards once a
step (only the cls loss reaches PMMA), the GCN backward once for each active
loss that reaches the GCN tokens.  Each optimizer takes its gradient
through the parameters' ``.grad`` (``train/state.py::apply_optimizer``): on
a card one launch of the multi-tensor AdamW kernel (``kernels/adamw.py``)
an optimizer, on the CPU torch's foreach AdamW.  After the step each
parameter's ``.grad`` holds the gradient its last optimizer applied.

The epoch driver runs S steps in one call, each gathering its batch from the
device-resident dataset by the (S, B) index plan, the chunk's LLM embeddings
gathered once before the loop.  It draws each step's dropout and MLM masks
from the one generator in step order, as a loop of ``make_train_step``
calls over host batches does (``Trainer``'s host pipeline), so the two take
the same draws on the same batch order.  Input given as numpy goes to the
device once, before the loop, from pinned memory without a host wait
(``to_device``).  The losses and the CM weight stay on the device (the
weight is carried from step to step as a device scalar): nothing inside the
loop (the profiler range ``epoch_step.loop``) reads a value back or waits
for the device, the calibrating epoch included.

While a profiler records, the steps mark their phases as ranges
(``utils.profiling.span``), one after another on the calling thread:
``druglamp.gather`` (a batch onto the device in its decoded form; the plan's
copy and the pre-gather once a chunk), ``druglamp.forward`` (the forward and
the losses, reduced over the ranks), ``druglamp.backward.<loss>`` (each
gradient, remat's recompute inside it; the CM gradient's scaling by the
weight, and over the ranks the gradients' all-reduce, in the last) and
``druglamp.optimizer.<loss>`` (each AdamW).  ``_calibrate`` lies in none.

The flat optimizer is ``train/state.py::FlatAdamW``.  ``DRUGLAMP_REMAT``
(``none`` | ``dots`` | ``full``), read when a step body is built, checkpoints
the step's forward region by region (``train/remat.py``); every mode gives
the same step bit for bit.  Not ported: ``make_repeat_step``, and the
loops over host-stacked batches (``make_epoch_step``, ``make_eval_scan``):
they exist for ``lax.scan``, and in eager PyTorch a stacked chunk is only a
loop of the same steps after an extra host copy.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from druglamp_tpu_torch.data.cache import BF16_HOST, bf16_tensor
from druglamp_tpu_torch.data.device_data import cm_arrays_device, gather_compact_batch
from druglamp_tpu_torch.data.encoding import decode_batch
from druglamp_tpu_torch.losses.classification import binary_cross_entropy, cross_entropy_logits
from druglamp_tpu_torch.parallel.mesh import MeshContext, current, replicas
from druglamp_tpu_torch.serve import resolve_device
from druglamp_tpu_torch.train import remat
from druglamp_tpu_torch.train.state import TrainState, apply_optimizer
from druglamp_tpu_torch.utils.numerics import train_numerics
from druglamp_tpu_torch.utils.profiling import span

GRAD_MODES = ("per_loss", "legacy_aliased")
# The step's phases, as profiler ranges (``utils.profiling.span``)
GATHER, FORWARD = "druglamp.gather", "druglamp.forward"
BACKWARD = {k: f"druglamp.backward.{k}" for k in ("cls", "ssl", "cm")}
OPTIMIZER = {k: f"druglamp.optimizer.{k}" for k in ("cls", "ssl", "cm")}


class StepOutput(NamedTuple):
    state: TrainState
    cls_loss: torch.Tensor
    ssl_loss: torch.Tensor
    cm_loss: torch.Tensor
    probs: torch.Tensor
    cm_weight: torch.Tensor


class EpochOutput(NamedTuple):
    state: TrainState
    cls_losses: torch.Tensor     # (S,)
    ssl_losses: torch.Tensor     # (S,)
    cm_losses: torch.Tensor      # (S,)
    cm_weight: torch.Tensor      # scalar, after the chunk
    generator: Optional[torch.Generator]   # advanced by the chunk's dropout draws


def _cls_loss(score: torch.Tensor, labels: torch.Tensor, n_class: int):
    if n_class == 1:
        return binary_cross_entropy(score, labels)
    return cross_entropy_logits(score, labels)


def host_tensor(v) -> torch.Tensor:
    """A batch leaf as a tensor: a tensor as it is, a numpy array as a CPU
    tensor over its memory (bf16 host arrays, uint16 bits, as bf16)."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype == BF16_HOST:
        return bf16_tensor(a)
    return torch.from_numpy(np.ascontiguousarray(a))


def tree_map(fn, batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in batch.items()}


def to_device(batch: Dict[str, Any], device: torch.device, keep: Optional[list] = None
              ) -> Dict[str, Any]:
    """A batch (numpy arrays or tensors, nested dicts) on ``device``.  To a
    card, host leaves are staged in pinned memory and copied without
    blocking: a copy from pageable memory makes the host wait for the
    stream.  ``keep`` collects the pinned staging tensors; the caller holds
    them until the batch has been consumed."""
    def one(v):
        t = host_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            pinned = t.pin_memory()
            if keep is not None:
                keep.append(pinned)
            return pinned.to(device, non_blocking=True)
        return t.to(device)
    return tree_map(one, batch)


# Each while loop of the reference's calibration, unrolled: exact while a loop
# runs at most this many times, i.e. while cm·w/cls lies within 10^±40.
CALIBRATE_STEPS = 40


def _calibrate(cm_loss: torch.Tensor, cls_loss: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Power-of-10 CM weight calibration (the JAX package's ``_calibrate``,
    reference trainer.py:214-219) on the device: while cm·w/10 > cls, w /= 10;
    then while cm·w·10 < cls, w *= 10; w unchanged unless cm > 0.  Each loop
    is CALIBRATE_STEPS ``torch.where`` steps that divide (multiply) only
    while the loop's condition holds, so the result is the loops' own, bit
    for bit, with no value read back to the host."""
    w0 = w
    for _ in range(CALIBRATE_STEPS):
        w = torch.where(cm_loss * w / 10.0 > cls_loss, w / 10.0, w)
    for _ in range(CALIBRATE_STEPS):
        w = torch.where(cm_loss * w * 10.0 < cls_loss, w * 10.0, w)
    return torch.where(cm_loss > 0, w, w0)


def _replicas(mesh: Optional[MeshContext]) -> Optional[MeshContext]:
    """``mesh`` when it spans more than one rank, else None."""
    return mesh if mesh is not None and mesh.n_data > 1 else None


def loss_gradients(model: nn.Module, batch: Dict[str, Any], generator: Optional[torch.Generator],
                   use_ssl: bool, use_cm: bool, calibrate: bool, margin: float,
                   cm_weight: torch.Tensor, n_class: int = 1,
                   mesh: Optional[MeshContext] = None, remat_mode: str = "none"):
    """The first half of a train step on a decoded batch: one train-mode
    forward, the active losses in the order cls, ssl, cm, and one gradient
    per active loss at the current parameters → (cls_loss, ssl_loss, cm_loss
    (the raw loss times the weight), probs, weight, {"cls" | "ssl" | "cm":
    one gradient per parameter of ``model.parameters()``, zeros where the
    loss does not reach; the CM gradient times the weight}).  Losses that are
    off are 0.

    Over the ranks of ``mesh`` (default: the ``parallel.mesh.replicas``
    context the caller runs it under) the batch is this rank's rows: the forward
    and backward run under ``parallel.mesh.replicas`` (global BatchNorm
    statistics, the MLM count and the CM mining of the global batch, or
    per-replica ones with ``model.bn_groups``), each rank's losses are such
    that their mean over the ranks is the global batch's, and the values
    returned are the global ones: the losses averaged over the ranks (the
    calibration sees those), the probabilities gathered in rank order, the
    gradient lists averaged (``MeshContext.all_reduce_grads``).

    ``remat_mode`` ``dots`` or ``full`` checkpoints the forward region by
    region (``train/remat.py``); the values returned are the same."""
    ctx = _replicas(mesh) if mesh is not None else current()
    params = list(model.parameters())
    regions = remat.Regions(model, remat_mode)
    with replicas(ctx):
        with span(FORWARD):
            with regions.forward():
                out = model(batch, generator=generator)
                probs, cls_loss = _cls_loss(out["score"], batch["labels"], n_class)
                zero = torch.zeros((), device=cls_loss.device)
                active = [("cls", cls_loss)]
                ssl_loss = cm_raw = zero
                if use_ssl:
                    ssl = model.ssl_loss(out["ssl_inputs"], generator)
                    ssl_loss = (ssl["prot_ssl"] + ssl["drug_ssl"]) * 0.1
                    active.append(("ssl", ssl_loss))
                if use_cm:
                    cm_raw = model.cm_loss(out["cm_inputs"], batch["cm"], margin)
                    active.append(("cm", cm_raw))
            values = [cls_loss.detach(), ssl_loss.detach(), cm_raw.detach()]
            if ctx is not None:
                values = list((ctx.all_reduce_sum(torch.stack(values)) / ctx.n_data).unbind())
                probs = ctx.gather_rows(probs.detach())
            probs = probs.detach()
        cls_v, ssl_v, cm_v = values
        w = _calibrate(cm_v, cls_v, cm_weight) if calibrate else cm_weight
        grads = {}
        try:
            for i, (name, loss) in enumerate(active):
                with span(BACKWARD[name]):
                    regions.before_gradient()
                    grads[name] = torch.autograd.grad(loss, params,
                                                      retain_graph=i + 1 < len(active),
                                                      allow_unused=True, materialize_grads=True)
                    if i + 1 < len(active):
                        continue
                    # after the last gradient, its saved outputs dropped: the ranks' mean
                    # of each gradient, then the CM weight, inside the last gradient's range
                    regions.release()
                    if ctx is not None:
                        grads = ctx.all_reduce_grads(grads)
                    if use_cm:
                        grads["cm"] = [g * w for g in grads["cm"]]
                    cm_v = cm_v * w
        finally:
            regions.release()
    return cls_v, ssl_v, cm_v, probs, w, grads


def _make_step_body(model: nn.Module, use_ssl: bool, use_cm: bool, calibrate: bool,
                    grad_mode: str, n_class: int,
                    mesh: Optional[MeshContext] = None) -> Callable[..., StepOutput]:
    """The single-step transition shared by ``make_train_step`` and
    ``make_epoch_step_gather``: ``body(state, batch, generator, lr_cls,
    lr_ssl, lr_cm, margin, cm_weight)`` on a batch of tensors on the model's
    device (an embedding store rides in ``batch["_store"]``); ``cm_weight``
    a float or a device scalar, returned as a device scalar.  Over the ranks
    of ``mesh`` the batch is this rank's rows (``loss_gradients``); with
    per-replica statistics (``model.bn_groups > 1``) rank 0's BatchNorm
    running stats, those of block 0, go to every rank after the step.
    ``DRUGLAMP_REMAT`` is read now (``train/remat.py::mode``)."""
    remat_mode = remat.mode()
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"grad_mode {grad_mode!r}: expected one of {GRAD_MODES}")
    if use_cm and not model.with_cm_inputs:
        raise ValueError(f"{type(model).__name__} returns no CM inputs; the CM loss is "
                         "DrugLAMP2C2P's")
    ctx = _replicas(mesh)

    def step_body(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator],
                  lr_cls: float, lr_ssl: float = 0.0, lr_cm: float = 0.0, margin: float = 0.5,
                  cm_weight=1.0) -> StepOutput:
        batch = dict(batch)
        with span(GATHER):
            batch = decode_batch(batch, batch.pop("_store", None))
        dev = batch["labels"].device
        if not isinstance(cm_weight, torch.Tensor):
            cm_weight = torch.full((), float(cm_weight), device=dev)
        model.train()
        with train_numerics(), replicas(ctx):
            cls_loss, ssl_loss, cm_loss, probs, w, grads = loss_gradients(
                model, batch, generator, use_ssl, use_cm, calibrate,
                float(np.float32(margin)), cm_weight, n_class, remat_mode=remat_mode)
            if grad_mode == "legacy_aliased":
                last = grads["cm" if use_cm else "ssl" if use_ssl else "cls"]
                grads = dict.fromkeys(grads, last)
            for name, opt, lr in (("cls", state.opt_cls, lr_cls), ("ssl", state.opt_ssl, lr_ssl),
                                  ("cm", state.opt_cm, lr_cm)):
                if name in grads:
                    with span(OPTIMIZER[name]):
                        for p, g in zip(model.parameters(), grads[name]):
                            p.grad = g
                        apply_optimizer(opt, lr)
        if ctx is not None and model.bn_groups > 1:
            ctx.broadcast_buffers(model)
        state.step += 1
        return StepOutput(state, cls_loss, ssl_loss, cm_loss, probs, w)

    return step_body


def make_train_step(model: nn.Module, use_ssl: bool, use_cm: bool, calibrate: bool = False,
                    grad_mode: str = "per_loss", n_class: int = 1, device="cuda",
                    mesh: Optional[MeshContext] = None) -> Callable[..., StepOutput]:
    """The per-step train function for one gate combination:
    ``step(state, batch, generator, lr_cls, lr_ssl=0, lr_cm=0, margin=0.5,
    cm_weight=1.0) → StepOutput``.  ``batch`` is a compact or standard
    batch (numpy arrays or tensors, moved to ``device``; the CM loss reads
    its ``cm`` ground truth); ``generator`` draws the dropout masks and then
    the MLM mask (a ``torch.Generator`` on ``device``, or None for torch's
    default).  ``state`` needs ``opt_ssl`` / ``opt_cm`` for the gates in
    use (``TrainState.create(model, use_ssl, use_cm)``).  Over the ranks of
    ``mesh`` (``parallel/mesh.py``) ``batch`` is this rank's rows
    (``MeshContext.shard_batch``; in global mode its ``cm`` is the whole
    batch's) and the outputs are the global batch's."""
    dev = resolve_device(device)
    body = _make_step_body(model, use_ssl, use_cm, calibrate, grad_mode, n_class, mesh)
    model.to(dev)

    def step(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator],
             lr_cls: float, lr_ssl: float = 0.0, lr_cm: float = 0.0, margin: float = 0.5,
             cm_weight=1.0) -> StepOutput:
        with span(GATHER):
            batch = to_device(batch, dev)
        return body(state, batch, generator, lr_cls, lr_ssl, lr_cm, margin, cm_weight)

    return step


# Pre-gathered (S, B, L, F) embeddings above this many bytes fall back to
# per-step gathers from the store (device-memory safety).
_PREGATHER_BUDGET = int(os.environ.get("DRUGLAMP_PREGATHER_BUDGET", str(6 << 30)))


def _pregather_embeddings(data_tree: Dict[str, torch.Tensor], emb_store, idx: torch.Tensor,
                          active: bool) -> Optional[Dict[str, torch.Tensor]]:
    """One gather of the whole chunk's LLM embeddings before the step loop.
    None when off, without a store, or over ``_PREGATHER_BUDGET``; else
    (S, B, ...) tensors whose step slices are what ``decode_batch``'s store
    branch would gather."""
    if not active or emb_store is None:
        return None
    S, B = idx.shape
    de, pe = emb_store["drug_emb"], emb_store["prot_emb"]
    nbytes = S * B * (de[0].numel() * de.element_size() + pe[0].numel() * pe.element_size())
    if nbytes > _PREGATHER_BUDGET:
        return None
    flat = idx.reshape(-1)
    dord = data_tree["pair_drug"].index_select(0, flat)
    pord = data_tree["pair_prot"].index_select(0, flat)

    def g(src, ids):
        return src.index_select(0, ids).reshape((S, B) + tuple(src.shape[1:]))

    return {"xd": g(de, dord), "d_ntok": g(emb_store["drug_len"], dord),
            "xp_src": g(pe, pord), "xp_len": g(emb_store["prot_len"], pord)}


def _plan_batches(idx, valid, data_tree, emb_store, include_llm: bool, emb_ordinals: bool,
                  device: torch.device, mesh: Optional[MeshContext] = None,
                  global_cm: bool = False) -> Iterator[Dict[str, Any]]:
    """The compact batches of an (S, B) index plan, this rank's columns of
    it over the ranks of ``mesh`` (with ``global_cm`` each batch's CM ground
    truth is the whole step's).  The plan's copy to the device and the
    chunk's pre-gather run now; the returned iterator gathers each step's
    batch on the device when it is reached (each gather a ``druglamp.gather``
    range, closed before the batch is handed on)."""
    with span(GATHER):
        plan = to_device({"idx": idx, "valid": valid}, device)
        full = plan["idx"]
        cols = mesh.rows(full.shape[1]) if mesh is not None else slice(None)
        idx, valid = full[:, cols], plan["valid"][:, cols]
        pref = _pregather_embeddings(data_tree, emb_store, idx, include_llm and emb_ordinals)

    def batches():
        for s in range(idx.shape[0]):
            with span(GATHER):
                batch = gather_compact_batch(data_tree, idx[s], valid[s], include_llm,
                                             emb_ordinals, emb_store, with_cm=not global_cm)
                if global_cm:
                    ids = full[s]
                    batch["cm"] = cm_arrays_device(data_tree["pair_prot"].index_select(0, ids),
                                                   data_tree["pair_drug"].index_select(0, ids),
                                                   data_tree["pair_label"].index_select(0, ids))
                if pref is not None:
                    del batch["drug_ord"], batch["prot_ord"]
                    batch.update({k: v[s] for k, v in pref.items()})  # xd/d_ntok/xp_src/xp_len
                elif emb_store is not None:
                    batch["_store"] = emb_store
            yield batch

    return batches()


def make_epoch_step_gather(model: nn.Module, use_ssl: bool, use_cm: bool, include_llm: bool,
                           emb_ordinals: bool, calibrate: bool = False,
                           grad_mode: str = "per_loss", n_class: int = 1,
                           device="cuda", mesh: Optional[MeshContext] = None
                           ) -> Callable[..., EpochOutput]:
    """The epoch-chunk driver over the device-resident dataset
    (``data/device_data.py``): ``epoch(state, idx, valid, data_tree,
    emb_store, generator, lr_cls, lr_ssl=0, lr_cm=0, margin=0.5,
    cm_weight=1.0) → EpochOutput`` runs S steps, one per row of the (S, B)
    index plan ``idx`` (numpy or tensor) with its validity mask ``valid``.
    ``data_tree`` is ``DeviceDataStore.tree_for(dataset)``, ``emb_store`` a
    ``DeviceEmbeddingStore.tree`` or None (woLLM).  The CM weight goes from
    each step to the next on the device; ``EpochOutput.cm_weight`` is the
    last step's.  Over the ranks of ``mesh`` every rank takes the whole plan
    and gathers its own columns of each step (``MeshContext.rows``), the CM
    ground truth of the whole step (per-replica mining trains over the host
    pipeline: ``DeviceDataStore.supports``)."""
    dev = resolve_device(device)
    ctx = _replicas(mesh)
    if ctx is not None and use_cm and model.bn_groups > 1:
        raise ValueError("per-replica CM mining (bn_groups > 1) trains over the host pipeline; "
                         "the gather epoch mines the whole step")
    body = _make_step_body(model, use_ssl, use_cm, calibrate, grad_mode, n_class, ctx)
    model.to(dev)

    def epoch_step(state: TrainState, idx, valid, data_tree: Dict[str, torch.Tensor],
                   emb_store, generator: Optional[torch.Generator], lr_cls: float,
                   lr_ssl: float = 0.0, lr_cm: float = 0.0, margin: float = 0.5,
                   cm_weight=1.0) -> EpochOutput:
        batches = _plan_batches(idx, valid, data_tree, emb_store, include_llm, emb_ordinals,
                                dev, ctx, global_cm=ctx is not None and use_cm)
        w = (cm_weight if isinstance(cm_weight, torch.Tensor)
             else torch.full((), float(cm_weight), device=dev))
        outs = []
        with span("epoch_step.loop"):
            for batch in batches:
                outs.append(body(state, batch, generator, lr_cls, lr_ssl, lr_cm, margin, w))
                w = outs[-1].cm_weight
        if not outs:
            raise ValueError("empty index plan")
        return EpochOutput(state, torch.stack([o.cls_loss for o in outs]),
                           torch.stack([o.ssl_loss for o in outs]),
                           torch.stack([o.cm_loss for o in outs]), outs[-1].cm_weight, generator)

    return epoch_step


def _eval_body(model: nn.Module, n_class: int,
               mesh: Optional[MeshContext] = None) -> Callable[[Dict[str, Any]], Any]:
    """``eval_step(batch) → (probs, loss)`` on a batch of tensors on the
    model's device: eval-mode forward; the loss is the BCE of the logits
    averaged over the rows whose ``valid`` is 1 (all rows when the batch has
    no ``valid``).  Over the ranks of ``mesh`` the batch is this rank's rows
    and the results are the global batch's: the probabilities gathered in
    rank order, the loss over every rank's valid rows."""
    ctx = _replicas(mesh)

    def eval_step(batch: Dict[str, Any]):
        batch = dict(batch)
        with span(GATHER):
            batch = decode_batch(batch, batch.pop("_store", None))
        with span(FORWARD):
            model.eval()
            out = model(batch)
            probs, _ = _cls_loss(out["score"], batch["labels"], n_class)
            valid = batch.get("valid")
            valid = torch.ones_like(probs) if valid is None else valid.float()
            logits = out["score"].squeeze(-1).float()
            labels = batch["labels"].float()
            per = (torch.clamp(logits, min=0.0) - logits * labels
                   + torch.log1p(torch.exp(-logits.abs())))
            num, den = (per * valid).sum(), valid.sum()
            if ctx is not None:
                num, den = ctx.all_reduce_sum(torch.stack([num, den]))
                probs = ctx.gather_rows(probs)
            return probs, num / torch.clamp(den, min=1.0)

    return eval_step


def make_eval_step(model: nn.Module, n_class: int = 1, device="cuda",
                   mesh: Optional[MeshContext] = None) -> Callable[[Dict[str, Any]], Any]:
    """``eval_step(batch) → (probs, loss)`` under ``no_grad`` on ``device``
    (over the ranks of ``mesh``: ``_eval_body``)."""
    dev = resolve_device(device)
    body = _eval_body(model, n_class, mesh)
    model.to(dev)

    @torch.no_grad()
    def eval_step(batch: Dict[str, Any]):
        with span(GATHER):
            batch = to_device(batch, dev)
        return body(batch)

    return eval_step


def make_eval_scan_gather(model: nn.Module, include_llm: bool, emb_ordinals: bool,
                          n_class: int = 1, device="cuda",
                          mesh: Optional[MeshContext] = None) -> Callable[..., Any]:
    """The eval twin of ``make_epoch_step_gather``: ``eval_scan(idx, valid,
    data_tree, emb_store) → (probs (S, B), losses (S,))`` scores the S
    index-gathered batches of the plan under ``no_grad`` (over the ranks of
    ``mesh`` each its own columns, the results the whole plan's)."""
    dev = resolve_device(device)
    ctx = _replicas(mesh)
    body = _eval_body(model, n_class, ctx)
    model.to(dev)

    @torch.no_grad()
    def eval_scan(idx, valid, data_tree: Dict[str, torch.Tensor], emb_store):
        outs = [body(batch) for batch in _plan_batches(idx, valid, data_tree, emb_store,
                                                       include_llm, emb_ordinals, dev, ctx)]
        if not outs:
            raise ValueError("empty index plan")
        return torch.stack([p for p, _ in outs]), torch.stack([l for _, l in outs])

    return eval_scan
