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
loss that reaches the GCN tokens.  After the step each parameter's
``.grad`` holds the gradient its last optimizer applied.

The epoch driver runs S steps in one call, each gathering its batch from the
device-resident dataset by the (S, B) index plan; the chunk's LLM embeddings
are gathered once before the loop.  A plan given as numpy goes to the device
once, before the loop, from pinned memory without a host wait.  The losses
and the CM weight stay on the device (the weight is carried from step to
step as a device scalar): nothing inside the loop (the profiler range
``epoch_step.loop``) reads a value back or waits for the device, the
calibrating epoch included.

Not ported yet: the flat optimizer, remat, and the drivers over
host-stacked batches (``make_epoch_step``, ``make_eval_scan``,
``make_repeat_step``; the host-pipeline slice).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from druglamp_tpu_torch.data.device_data import gather_compact_batch
from druglamp_tpu_torch.data.encoding import decode_batch
from druglamp_tpu_torch.losses.classification import binary_cross_entropy, cross_entropy_logits
from druglamp_tpu_torch.serve import resolve_device
from druglamp_tpu_torch.train.state import TrainState, apply_optimizer
from druglamp_tpu_torch.utils.numerics import train_numerics

GRAD_MODES = ("per_loss", "legacy_aliased")


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


def _on_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: (_on_device(v, device) if isinstance(v, dict)
                else torch.as_tensor(v, device=device)) for k, v in batch.items()}


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


def loss_gradients(model: nn.Module, batch: Dict[str, Any], generator: Optional[torch.Generator],
                   use_ssl: bool, use_cm: bool, calibrate: bool, margin: float,
                   cm_weight: torch.Tensor, n_class: int = 1):
    """The first half of a train step on a decoded batch: one train-mode
    forward, the active losses in the order cls, ssl, cm, and one gradient
    per active loss at the current parameters → (cls_loss, ssl_loss, cm_loss
    (the raw loss times the weight), probs, weight, {"cls" | "ssl" | "cm":
    one gradient per parameter of ``model.parameters()``, zeros where the
    loss does not reach; the CM gradient times the weight}).  Losses that are
    off are 0."""
    params = list(model.parameters())
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
    w = _calibrate(cm_raw.detach(), cls_loss.detach(), cm_weight) if calibrate else cm_weight
    grads = {}
    for i, (name, loss) in enumerate(active):
        grads[name] = torch.autograd.grad(loss, params, retain_graph=i + 1 < len(active),
                                          allow_unused=True, materialize_grads=True)
    if use_cm:
        grads["cm"] = [g * w for g in grads["cm"]]
    return (cls_loss.detach(), ssl_loss.detach(), (cm_raw * w).detach(), probs.detach(), w,
            grads)


def _make_step_body(model: nn.Module, use_ssl: bool, use_cm: bool, calibrate: bool,
                    grad_mode: str, n_class: int) -> Callable[..., StepOutput]:
    """The single-step transition shared by ``make_train_step`` and
    ``make_epoch_step_gather``: ``body(state, batch, generator, lr_cls,
    lr_ssl, lr_cm, margin, cm_weight)`` on a batch of tensors on the model's
    device (an embedding store rides in ``batch["_store"]``); ``cm_weight``
    a float or a device scalar, returned as a device scalar."""
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"grad_mode {grad_mode!r}: expected one of {GRAD_MODES}")
    if use_cm and not model.with_cm_inputs:
        raise ValueError(f"{type(model).__name__} returns no CM inputs; the CM loss is "
                         "DrugLAMP2C2P's")

    def step_body(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator],
                  lr_cls: float, lr_ssl: float = 0.0, lr_cm: float = 0.0, margin: float = 0.5,
                  cm_weight=1.0) -> StepOutput:
        batch = dict(batch)
        batch = decode_batch(batch, batch.pop("_store", None))
        dev = batch["labels"].device
        if not isinstance(cm_weight, torch.Tensor):
            cm_weight = torch.full((), float(cm_weight), device=dev)
        model.train()
        with train_numerics():
            cls_loss, ssl_loss, cm_loss, probs, w, grads = loss_gradients(
                model, batch, generator, use_ssl, use_cm, calibrate,
                float(np.float32(margin)), cm_weight, n_class)
            if grad_mode == "legacy_aliased":
                last = grads["cm" if use_cm else "ssl" if use_ssl else "cls"]
                grads = dict.fromkeys(grads, last)
            for name, opt, lr in (("cls", state.opt_cls, lr_cls), ("ssl", state.opt_ssl, lr_ssl),
                                  ("cm", state.opt_cm, lr_cm)):
                if name in grads:
                    for p, g in zip(model.parameters(), grads[name]):
                        p.grad = g
                    apply_optimizer(opt, lr)
        state.step += 1
        return StepOutput(state, cls_loss, ssl_loss, cm_loss, probs, w)

    return step_body


def make_train_step(model: nn.Module, use_ssl: bool, use_cm: bool, calibrate: bool = False,
                    grad_mode: str = "per_loss", n_class: int = 1,
                    device="cuda") -> Callable[..., StepOutput]:
    """The per-step train function for one gate combination:
    ``step(state, batch, generator, lr_cls, lr_ssl=0, lr_cm=0, margin=0.5,
    cm_weight=1.0) → StepOutput``.  ``batch`` is a compact or standard
    batch (numpy arrays or tensors, moved to ``device``; the CM loss reads
    its ``cm`` ground truth); ``generator`` draws the dropout masks and then
    the MLM mask (a ``torch.Generator`` on ``device``, or None for torch's
    default).  ``state`` needs ``opt_ssl`` / ``opt_cm`` for the gates in
    use (``TrainState.create(model, use_ssl, use_cm)``)."""
    dev = resolve_device(device)
    body = _make_step_body(model, use_ssl, use_cm, calibrate, grad_mode, n_class)
    model.to(dev)

    def step(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator],
             lr_cls: float, lr_ssl: float = 0.0, lr_cm: float = 0.0, margin: float = 0.5,
             cm_weight=1.0) -> StepOutput:
        return body(state, _on_device(batch, dev), generator, lr_cls, lr_ssl, lr_cm, margin,
                    cm_weight)

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


def _plan_to_device(a, device: torch.device) -> torch.Tensor:
    """The plan on ``device``.  From the host to a card it is staged in
    pinned memory and copied without blocking: a copy from pageable memory
    makes the host wait for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _plan_batches(idx, valid, data_tree, emb_store, include_llm: bool, emb_ordinals: bool,
                  device: torch.device) -> Iterator[Dict[str, Any]]:
    """The compact batches of an (S, B) index plan.  The plan's copy to the
    device and the chunk's pre-gather run now; the returned iterator gathers
    each step's batch on the device when it is reached."""
    idx = _plan_to_device(idx, device)
    valid = _plan_to_device(valid, device)
    pref = _pregather_embeddings(data_tree, emb_store, idx, include_llm and emb_ordinals)

    def batches():
        for s in range(idx.shape[0]):
            batch = gather_compact_batch(data_tree, idx[s], valid[s], include_llm, emb_ordinals,
                                         emb_store)
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
                           device="cuda") -> Callable[..., EpochOutput]:
    """The epoch-chunk driver over the device-resident dataset
    (``data/device_data.py``): ``epoch(state, idx, valid, data_tree,
    emb_store, generator, lr_cls, lr_ssl=0, lr_cm=0, margin=0.5,
    cm_weight=1.0) → EpochOutput`` runs S steps, one per row of the (S, B)
    index plan ``idx`` (numpy or tensor) with its validity mask ``valid``.
    ``data_tree`` is ``DeviceDataStore.tree_for(dataset)``, ``emb_store`` a
    ``DeviceEmbeddingStore.tree`` or None (woLLM).  The CM weight goes from
    each step to the next on the device; ``EpochOutput.cm_weight`` is the
    last step's."""
    dev = resolve_device(device)
    body = _make_step_body(model, use_ssl, use_cm, calibrate, grad_mode, n_class)
    model.to(dev)

    def epoch_step(state: TrainState, idx, valid, data_tree: Dict[str, torch.Tensor],
                   emb_store, generator: Optional[torch.Generator], lr_cls: float,
                   lr_ssl: float = 0.0, lr_cm: float = 0.0, margin: float = 0.5,
                   cm_weight=1.0) -> EpochOutput:
        batches = _plan_batches(idx, valid, data_tree, emb_store, include_llm, emb_ordinals,
                                dev)
        w = (cm_weight if isinstance(cm_weight, torch.Tensor)
             else torch.full((), float(cm_weight), device=dev))
        outs = []
        with torch.profiler.record_function("epoch_step.loop"):
            for batch in batches:
                outs.append(body(state, batch, generator, lr_cls, lr_ssl, lr_cm, margin, w))
                w = outs[-1].cm_weight
        if not outs:
            raise ValueError("empty index plan")
        return EpochOutput(state, torch.stack([o.cls_loss for o in outs]),
                           torch.stack([o.ssl_loss for o in outs]),
                           torch.stack([o.cm_loss for o in outs]), outs[-1].cm_weight, generator)

    return epoch_step


def _eval_body(model: nn.Module, n_class: int) -> Callable[[Dict[str, Any]], Any]:
    """``eval_step(batch) → (probs, loss)`` on a batch of tensors on the
    model's device: eval-mode forward; the loss is the BCE of the logits
    averaged over the rows whose ``valid`` is 1 (all rows when the batch has
    no ``valid``)."""

    def eval_step(batch: Dict[str, Any]):
        batch = dict(batch)
        batch = decode_batch(batch, batch.pop("_store", None))
        model.eval()
        out = model(batch)
        probs, _ = _cls_loss(out["score"], batch["labels"], n_class)
        valid = batch.get("valid")
        valid = torch.ones_like(probs) if valid is None else valid.float()
        logits = out["score"].squeeze(-1).float()
        labels = batch["labels"].float()
        per = (torch.clamp(logits, min=0.0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs())))
        loss = (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)
        return probs, loss

    return eval_step


def make_eval_step(model: nn.Module, n_class: int = 1,
                   device="cuda") -> Callable[[Dict[str, Any]], Any]:
    """``eval_step(batch) → (probs, loss)`` under ``no_grad`` on ``device``."""
    dev = resolve_device(device)
    body = _eval_body(model, n_class)
    model.to(dev)

    @torch.no_grad()
    def eval_step(batch: Dict[str, Any]):
        return body(_on_device(batch, dev))

    return eval_step


def make_eval_scan_gather(model: nn.Module, include_llm: bool, emb_ordinals: bool,
                          n_class: int = 1, device="cuda") -> Callable[..., Any]:
    """The eval twin of ``make_epoch_step_gather``: ``eval_scan(idx, valid,
    data_tree, emb_store) → (probs (S, B), losses (S,))`` scores the S
    index-gathered batches of the plan under ``no_grad``."""
    dev = resolve_device(device)
    body = _eval_body(model, n_class)
    model.to(dev)

    @torch.no_grad()
    def eval_scan(idx, valid, data_tree: Dict[str, torch.Tensor], emb_store):
        outs = [body(batch) for batch in _plan_batches(idx, valid, data_tree, emb_store,
                                                       include_llm, emb_ordinals, dev)]
        if not outs:
            raise ValueError("empty index plan")
        return torch.stack([p for p, _ in outs]), torch.stack([l for _, l in outs])

    return eval_scan
