"""Train and eval steps (port of ``druglamp_tpu/train/steps.py``: the cls
gate of ``_make_step_body``, ``make_train_step``, ``make_eval_step``, and the
device-resident-dataset drivers ``make_epoch_step_gather`` and
``make_eval_scan_gather``).

    step = make_train_step(model, use_ssl=False, use_cm=False)   # moves model to cuda
    state = TrainState.create(model)
    out = step(state, batch, generator, lr_cls)        # out.cls_loss, out.probs

    epoch = make_epoch_step_gather(model, False, False, include_llm=True, emb_ordinals=True)
    out = epoch(state, idx, valid, data_tree, emb_store, generator, lr_cls)  # out.cls_losses (S,)
    probs, losses = make_eval_scan_gather(model, True, True)(idx, valid, data_tree, emb_store)

Every builder moves the model to ``device`` (``cuda`` unless the caller asks
for ``cpu``; it raises if ``cuda`` is asked for and absent).

One step (``_make_step_body``): ``decode_batch`` (a compact batch is expanded
on the device; its adjacency stays packed where ``kernels.gcn.use_packed_gcn``
says so) → train-mode forward (BatchNorm uses batch statistics and updates
its running stats in place, as flax's ``mutable=["batch_stats"]``; dropout
masks come from ``generator``) → the cls loss, mean over all rows → one
``backward()`` → an AdamW step of ``opt_cls`` at ``lr_cls``.  With the cls
loss alone both grad modes apply the cls gradient, so both are accepted.  On
a CUDA model the PMMA attention and the packed GCN run through their
hand-written kernels, forward and backward.  After the step each parameter's
``.grad`` holds its gradient.

The epoch driver runs S steps in one call, each gathering its batch from the
device-resident dataset by the (S, B) index plan; the chunk's LLM embeddings
are gathered once before the loop.  The losses stay on the device as (S,)
tensors: nothing inside the loop reads a value back to the host.

Not ported yet, and refused: the SSL and CM gates and the CM weight
calibration (the SSL/CM slice), the flat optimizer, remat, and the drivers
over host-stacked batches (``make_epoch_step``, ``make_eval_scan``,
``make_repeat_step``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from druglamp_tpu_torch.data.device_data import gather_compact_batch
from druglamp_tpu_torch.data.encoding import decode_batch
from druglamp_tpu_torch.losses.classification import binary_cross_entropy, cross_entropy_logits
from druglamp_tpu_torch.serve import resolve_device
from druglamp_tpu_torch.train.state import TrainState, apply_optimizer

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


def _make_step_body(model: nn.Module, use_ssl: bool, use_cm: bool, calibrate: bool,
                    grad_mode: str, n_class: int) -> Callable[..., StepOutput]:
    """The single-step transition shared by ``make_train_step`` and
    ``make_epoch_step_gather``: ``body(state, batch, generator, lr_cls,
    lr_ssl, lr_cm, margin, cm_weight)`` on a batch of tensors on the model's
    device (an embedding store rides in ``batch["_store"]``)."""
    if use_ssl or use_cm or calibrate:
        raise NotImplementedError("the SSL and CM gates and the CM weight calibration belong "
                                  "to the SSL/CM slice")
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"grad_mode {grad_mode!r}: expected one of {GRAD_MODES}")

    def step_body(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator],
                  lr_cls: float, lr_ssl: float = 0.0, lr_cm: float = 0.0, margin: float = 0.5,
                  cm_weight: float = 1.0) -> StepOutput:
        batch = dict(batch)
        batch = decode_batch(batch, batch.pop("_store", None))
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(batch, generator=generator)
        probs, cls_loss = _cls_loss(out["score"], batch["labels"], n_class)
        cls_loss.backward()
        apply_optimizer(state.opt_cls, lr_cls)
        state.step += 1
        zero = torch.zeros((), device=cls_loss.device)
        return StepOutput(state, cls_loss.detach(), zero, zero, probs.detach(),
                          torch.full((), float(cm_weight), device=cls_loss.device))

    return step_body


def make_train_step(model: nn.Module, use_ssl: bool, use_cm: bool, calibrate: bool = False,
                    grad_mode: str = "per_loss", n_class: int = 1,
                    device="cuda") -> Callable[..., StepOutput]:
    """The per-step train function for one gate combination:
    ``step(state, batch, generator, lr_cls, lr_ssl=0, lr_cm=0, margin=0.5,
    cm_weight=1.0) → StepOutput``.  ``batch`` is a compact or standard
    batch (numpy arrays or tensors, moved to ``device``); ``generator``
    draws the dropout masks (a ``torch.Generator`` on ``device``, or None
    for torch's default)."""
    dev = resolve_device(device)
    body = _make_step_body(model, use_ssl, use_cm, calibrate, grad_mode, n_class)
    model.to(dev)

    def step(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator],
             lr_cls: float, lr_ssl: float = 0.0, lr_cm: float = 0.0, margin: float = 0.5,
             cm_weight: float = 1.0) -> StepOutput:
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


def _plan_batches(idx, valid, data_tree, emb_store, include_llm: bool, emb_ordinals: bool,
                  device: torch.device):
    """The compact batches of an (S, B) index plan, gathered on the device
    one step at a time (the plan is copied to the device once)."""
    idx = torch.as_tensor(idx, device=device)
    valid = torch.as_tensor(valid, device=device)
    pref = _pregather_embeddings(data_tree, emb_store, idx, include_llm and emb_ordinals)
    for s in range(idx.shape[0]):
        batch = gather_compact_batch(data_tree, idx[s], valid[s], include_llm, emb_ordinals,
                                     emb_store)
        if pref is not None:
            del batch["drug_ord"], batch["prot_ord"]
            batch.update({k: v[s] for k, v in pref.items()})     # xd/d_ntok/xp_src/xp_len
        elif emb_store is not None:
            batch["_store"] = emb_store
        yield batch


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
    ``DeviceEmbeddingStore.tree`` or None (woLLM)."""
    dev = resolve_device(device)
    body = _make_step_body(model, use_ssl, use_cm, calibrate, grad_mode, n_class)
    model.to(dev)

    def epoch_step(state: TrainState, idx, valid, data_tree: Dict[str, torch.Tensor],
                   emb_store, generator: Optional[torch.Generator], lr_cls: float,
                   lr_ssl: float = 0.0, lr_cm: float = 0.0, margin: float = 0.5,
                   cm_weight: float = 1.0) -> EpochOutput:
        outs = [body(state, batch, generator, lr_cls, lr_ssl, lr_cm, margin, cm_weight)
                for batch in _plan_batches(idx, valid, data_tree, emb_store, include_llm,
                                           emb_ordinals, dev)]
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
