"""Train state: the three AdamW optimizers of the reference (port of
``druglamp_tpu/train/state.py``, per-leaf path).

The reference builds three torch AdamW optimizers over the same parameters
for the cls, SSL and CM losses, with β (0.9, 0.999), eps 1e-8 and decoupled
weight decay 0.01, and no learning rate of their own: the step passes each
loss's LR, which scales the decay term too (p ← p − lr·(adam(g) + wd·p)).
The parameters and BatchNorm statistics live in the model; this state holds
the optimizers and the step count, and the step updates both in place.
Only ``opt_cls`` exists in this slice; ``opt_ssl`` and ``opt_cm`` belong to
the SSL/CM slice.
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
        if use_ssl or use_cm:
            raise NotImplementedError("the SSL and CM optimizers belong to the SSL/CM slice")
        return cls(opt_cls=make_adamw(model.parameters()))


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
