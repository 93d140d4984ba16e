"""Faults planted in the program's timed path, underneath an otherwise whole
run, to show that the comparison deciding ``correct`` catches them
(``calibrate.py --fault``, ``tests/test_portbench_faults.py``).  Each is a
context manager that patches ``druglamp_tpu_torch.train.steps`` and
restores it.

- ``unchanged``: a training step leaves its state as it was (no optimizer
  applies);
- ``half_batch``: a training step's cls loss, or a scoring batch, leaves out
  the second half of the batch (the mean over the rest; the left-out rows'
  answers are the kept rows');
- ``altered``: the answer is altered where it is produced (a training
  step's cls loss scaled by 1.01; a scoring batch's first probability p
  given as 1 − p).
"""

from __future__ import annotations

import contextlib

import torch


def _rows(batch, keep):
    """The batch with its rows after the first ``keep`` replaced by copies of them."""
    n = batch["labels"].shape[0]
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == n:
            v = v[:keep].repeat((-(-n // keep),) + (1,) * (v.dim() - 1))[:n]
        out[k] = v
    return out


@contextlib.contextmanager
def planted(name: str):
    from druglamp_tpu_torch.train import steps

    saved = {k: getattr(steps, k) for k in ("apply_optimizer", "_cls_loss", "_eval_body")}
    whole, body = saved["_cls_loss"], saved["_eval_body"]

    def half(score, labels, n_class):
        h = score.shape[0] // 2
        probs, loss = whole(score[:h], labels[:h], n_class)
        return torch.cat([probs, probs]), loss

    def altered(score, labels, n_class):
        probs, loss = whole(score, labels, n_class)
        return probs, loss * 1.01

    def half_body(model, n_class, mesh=None):
        run = body(model, n_class, mesh)
        return lambda batch: run(_rows(batch, batch["labels"].shape[0] // 2))

    def altered_body(model, n_class, mesh=None):
        run = body(model, n_class, mesh)

        def score(batch):
            probs, loss = run(batch)
            return torch.cat([1.0 - probs[:1], probs[1:]]), loss
        return score

    patches = {"unchanged": {"apply_optimizer": lambda opt, lr: None},
               "half_batch": {"_cls_loss": half, "_eval_body": half_body},
               "altered": {"_cls_loss": altered, "_eval_body": altered_body}}[name]
    try:
        for k, v in patches.items():
            setattr(steps, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(steps, k, v)
