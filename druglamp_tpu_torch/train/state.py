"""Train state: the three AdamW optimizers of the reference (port of
``druglamp_tpu/train/state.py``, per-leaf path).

The reference builds three torch AdamW optimizers over the same parameters
for the cls, SSL and CM losses, with β (0.9, 0.999), eps 1e-8 and decoupled
weight decay 0.01, and no learning rate of their own: the step passes each
loss's LR, which scales the decay term too (p ← p − lr·(adam(g) + wd·p)).
The parameters and BatchNorm statistics live in the model; this state holds
the optimizers and the step count, and the step updates both in place.
``opt_ssl`` and ``opt_cm`` exist when their loss is in use, each an AdamW
over *all* the model's parameters, as ``opt_cls``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch

WEIGHT_DECAY = 0.01
B1, B2, EPS = 0.9, 0.999, 1e-8


def make_adamw(params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
    """torch AdamW with the reference's settings; the LR is set per step."""
    return torch.optim.AdamW(list(params), lr=0.0, betas=(B1, B2), eps=EPS,
                             weight_decay=WEIGHT_DECAY, foreach=True)


@dataclass
class TrainState:
    opt_cls: torch.optim.AdamW
    opt_ssl: Optional[torch.optim.AdamW] = None
    opt_cm: Optional[torch.optim.AdamW] = None
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, use_ssl: bool = False,
               use_cm: bool = False) -> "TrainState":
        return cls(opt_cls=make_adamw(model.parameters()),
                   opt_ssl=make_adamw(model.parameters()) if use_ssl else None,
                   opt_cm=make_adamw(model.parameters()) if use_cm else None)

    def state_dict(self) -> dict:
        """The three optimizers' states and the step count (for a checkpoint)."""
        return {"step": self.step,
                **{name: (None if opt is None else opt.state_dict())
                   for name, opt in (("opt_cls", self.opt_cls), ("opt_ssl", self.opt_ssl),
                                     ("opt_cm", self.opt_cm))}}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        for name in ("opt_cls", "opt_ssl", "opt_cm"):
            opt = getattr(self, name)
            if opt is not None and state.get(name) is not None:
                opt.load_state_dict(state[name])


def apply_optimizer(opt: torch.optim.AdamW, lr: float) -> None:
    """One AdamW step at ``lr`` on the parameters' ``.grad``.  A parameter
    whose ``.grad`` is None gets a zero gradient first, so it still decays,
    as every leaf of the JAX tree does.  On a CUDA model the optimizer keeps
    its step count on the device (``capturable``): the bias corrections are
    then computed there, and the step reads nothing back to the host."""
    for group in opt.param_groups:
        group["lr"] = float(lr)
        group["capturable"] = group["params"][0].is_cuda
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()
