"""Train and eval steps (port of ``druglamp_tpu/train/steps.py``: the cls
gate of ``_make_step_body`` / ``make_train_step``, and ``make_eval_step``).

    step = make_train_step(model, use_ssl=False, use_cm=False)   # moves model to cuda
    state = TrainState.create(model)
    out = step(state, batch, generator, lr_cls)        # out.cls_loss, out.probs

Both step builders move the model to ``device`` (``cuda`` unless the
caller asks for ``cpu``; they raise if ``cuda`` is asked for and absent),
and each call moves the batch (numpy arrays or tensors) there.

One step: ``decode_batch`` (a compact batch is expanded on the device) →
train-mode forward (BatchNorm uses batch statistics and updates its running
stats in place, as flax's ``mutable=["batch_stats"]``; dropout masks come
from ``generator``) → the cls loss, mean over all rows → one ``backward()``
→ an AdamW step of ``opt_cls`` at ``lr_cls``.  With the cls loss alone both
grad modes apply the cls gradient, so both are accepted.  On a CUDA model
the PMMA attention runs through the hand-written forward and backward
kernels.  After the step each parameter's ``.grad`` holds its gradient.

Not ported yet, and refused: the SSL and CM gates and the CM weight
calibration (the SSL/CM slice), the flat optimizer and remat.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

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


def _cls_loss(score: torch.Tensor, labels: torch.Tensor, n_class: int):
    if n_class == 1:
        return binary_cross_entropy(score, labels)
    return cross_entropy_logits(score, labels)


def _on_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: (v if k == "_store" else torch.as_tensor(v, device=device))
            for k, v in batch.items()}


def make_train_step(model: nn.Module, use_ssl: bool, use_cm: bool, calibrate: bool = False,
                    grad_mode: str = "per_loss", n_class: int = 1,
                    device="cuda") -> Callable[..., StepOutput]:
    """The per-step train function for one gate combination:
    ``step(state, batch, generator, lr_cls, lr_ssl=0, lr_cm=0, margin=0.5,
    cm_weight=1.0) → StepOutput``.  ``batch`` is a compact or standard
    batch; ``generator`` draws the dropout masks (a ``torch.Generator`` on
    ``device``, or None for torch's default)."""
    dev = resolve_device(device)
    if use_ssl or use_cm or calibrate:
        raise NotImplementedError("the SSL and CM gates and the CM weight calibration belong "
                                  "to the SSL/CM slice")
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"grad_mode {grad_mode!r}: expected one of {GRAD_MODES}")
    model.to(dev)

    def step(state: TrainState, batch: Dict[str, Any], generator: Optional[torch.Generator],
             lr_cls: float, lr_ssl: float = 0.0, lr_cm: float = 0.0, margin: float = 0.5,
             cm_weight: float = 1.0) -> StepOutput:
        batch = _on_device(batch, dev)
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

    return step


def make_eval_step(model: nn.Module, n_class: int = 1,
                   device="cuda") -> Callable[[Dict[str, Any]], Any]:
    """``eval_step(batch) → (probs, loss)``: eval-mode forward under
    ``no_grad`` on ``device``; the loss is the BCE of the logits averaged
    over the rows whose ``valid`` is 1 (all rows when the batch has no
    ``valid``)."""
    dev = resolve_device(device)
    model.to(dev)

    @torch.no_grad()
    def eval_step(batch: Dict[str, Any]):
        batch = _on_device(batch, dev)
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
