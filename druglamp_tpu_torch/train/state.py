"""Train state: the three AdamW optimizers of the reference (port of
``druglamp_tpu/train/state.py``: the per-leaf optimizers and, with
``DRUGLAMP_FLAT_OPT=1``, the flat one).

The reference builds three torch AdamW optimizers over the same parameters
for the cls, SSL and CM losses, with β (0.9, 0.999), eps 1e-8 and decoupled
weight decay 0.01, and no learning rate of their own: the step passes each
loss's LR, which scales the decay term too (p ← p − lr·(adam(g) + wd·p)).
The parameters and BatchNorm statistics live in the model; this state holds
the optimizers and the step count, and the step updates both in place.
``opt_ssl`` and ``opt_cm`` exist when their loss is in use, each an AdamW
over *all* the model's parameters, as ``opt_cls``.

Each per-leaf optimizer is a ``torch.optim.AdamW``, and its state is torch's
(``opt.state[p]``).  On the CPU ``apply_optimizer`` runs torch's foreach
step.  On a card it runs the same arithmetic through the hand-written
multi-tensor kernel ``kernels/adamw.py`` (``csrc/adamw.cu``): one launch for
all the leaves, where torch's foreach ops take 528 over DrugLAMP's 236, the
step counts and bias corrections on the device, nothing read back.

``FlatAdamW`` (``TrainState.create(..., flat_opt=True)``, by default
``DRUGLAMP_FLAT_OPT=1``) is the JAX package's ``FlatAdamWState``: the
moments of every parameter in one f32 buffer each (``m``, ``v``, raveled in
``model.parameters()`` order) and a device step ``count``; a step ravels the
parameters and gradients into buffers the optimizer keeps, updates the
moments and parameters there in place as ``_apply_optimizer_flat`` does, op
for op, and copies the parameters back.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Union

import torch

WEIGHT_DECAY = 0.01
B1, B2, EPS = 0.9, 0.999, 1e-8


def make_adamw(params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
    """torch AdamW with the reference's settings; the LR is set per step."""
    return torch.optim.AdamW(list(params), lr=0.0, betas=(B1, B2), eps=EPS,
                             weight_decay=WEIGHT_DECAY, foreach=True)


def _flat_opt_default() -> bool:
    return os.environ.get("DRUGLAMP_FLAT_OPT", "0") == "1"


class FlatAdamW:
    """AdamW over one raveled buffer (the JAX package's ``FlatAdamWState`` and
    ``_apply_optimizer_flat``): ``m`` and ``v`` hold the moments of every
    parameter, raveled in ``params`` order, in f32, and ``count`` the steps
    taken, an int32 on the parameters' device.  A step at ``lr`` ravels the
    parameters and the gradients (a ``.grad`` of None counts as zeros) into
    the optimizer's ``flat`` and ``grad`` buffers, then, in place,

        count += 1;  m = β1·m + (1 − β1)·g;  v = β2·v + (1 − β2)·g²
        m̂ = m / (1 − β1^count);  v̂ = v / (1 − β2^count)      (f32)
        p ← p − lr·(m̂ / (√v̂ + ε) + wd·p)

    and copies the parameters back.  The parameters keep their own tensors:
    laid out as the moments are, most would sit at offsets a GEMM reads
    unaligned.  A parameter whose ``.data`` is replaced
    (``MeshContext.shard_params``) stays the one updated; the moments must
    then match its new size (``MeshContext.shard_state`` cuts them), and the
    buffers are made again.  Nothing is read back to the host."""

    def __init__(self, params: Iterable[torch.nn.Parameter]):
        self.params: List[torch.nn.Parameter] = list(params)
        n = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.m = torch.zeros(n, dtype=torch.float32, device=dev)
        self.v = torch.zeros(n, dtype=torch.float32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.flat: Optional[torch.Tensor] = None     # the parameters, raveled each step
        self.grad: Optional[torch.Tensor] = None     # the gradients, raveled each step

    def _buffers(self) -> None:
        """``m``, ``v`` and ``count`` on the parameters' device, and ``flat``
        and ``grad`` of their size there."""
        n = sum(p.numel() for p in self.params)
        if n != self.m.numel():
            raise ValueError(f"flat AdamW: {self.m.numel()} moments for {n} parameter entries "
                             "(shard the state with the parameters)")
        dev = self.params[0].device
        if self.m.device != dev:
            self.m, self.v, self.count = (t.to(dev) for t in (self.m, self.v, self.count))
        if self.flat is None or self.flat.numel() != n or self.flat.device != dev:
            self.flat = torch.empty(n, dtype=torch.float32, device=dev)
            self.grad = torch.empty_like(self.flat)

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self._buffers()
        ps, p, g = self.params, self.flat, self.grad
        torch.cat([q.reshape(-1) for q in ps], out=p)
        torch.cat([(q.grad if q.grad is not None else torch.zeros_like(q)).reshape(-1)
                   for q in ps], out=g)
        self.count += 1
        c = self.count.float()
        self.m.mul_(B1).add_(g * (1.0 - B1))
        self.v.mul_(B2).add_((g * g) * (1.0 - B2))
        denom = self.v / (1.0 - torch.pow(B2, c))
        denom.sqrt_().add_(EPS)
        u = self.m / (1.0 - torch.pow(B1, c))
        u.div_(denom).add_(p * WEIGHT_DECAY).mul_(float(lr))
        p.sub_(u)
        torch._foreach_copy_(ps, [piece.view(q.shape)
                                  for piece, q in zip(p.split([q.numel() for q in ps]), ps)])

    def state_dict(self) -> dict:
        return {"m": self.m, "v": self.v, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """``m``, ``v`` and ``count`` copied into this optimizer's buffers."""
        if set(state) != {"m", "v", "count"}:
            raise ValueError(f"a flat AdamW state holds m, v and count, not {sorted(state)}")
        if state["m"].shape != self.m.shape or state["v"].shape != self.v.shape:
            raise ValueError(f"flat AdamW state of {tuple(state['m'].shape)} entries, this "
                             f"optimizer {tuple(self.m.shape)}")
        self.m.copy_(state["m"])
        self.v.copy_(state["v"])
        self.count.copy_(state["count"].reshape(()))


Optimizer = Union[torch.optim.AdamW, FlatAdamW]


@dataclass
class TrainState:
    opt_cls: Optimizer
    opt_ssl: Optional[Optimizer] = None
    opt_cm: Optional[Optimizer] = None
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, use_ssl: bool = False, use_cm: bool = False,
               flat_opt: Optional[bool] = None) -> "TrainState":
        """The optimizers of the gates in use: per-leaf torch AdamWs, or
        ``FlatAdamW``s with ``flat_opt`` (default ``DRUGLAMP_FLAT_OPT=1``)."""
        flat = _flat_opt_default() if flat_opt is None else flat_opt
        make = FlatAdamW if flat else make_adamw
        return cls(opt_cls=make(model.parameters()),
                   opt_ssl=make(model.parameters()) if use_ssl else None,
                   opt_cm=make(model.parameters()) if use_cm else None)

    def state_dict(self) -> dict:
        """The three optimizers' states and the step count (for a checkpoint)."""
        return {"step": self.step,
                **{name: (None if opt is None else opt.state_dict())
                   for name, opt in (("opt_cls", self.opt_cls), ("opt_ssl", self.opt_ssl),
                                     ("opt_cm", self.opt_cm))}}

    def load_state_dict(self, state: dict) -> None:
        """Each optimizer's state by name; a flat state into a per-leaf
        optimizer, or the reverse, raises ValueError."""
        self.step = int(state["step"])
        for name in ("opt_cls", "opt_ssl", "opt_cm"):
            opt = getattr(self, name)
            if opt is not None and state.get(name) is not None:
                flat = "count" in state[name]
                if flat != isinstance(opt, FlatAdamW):
                    raise ValueError(f"{name}: a {'flat' if flat else 'per-leaf'} AdamW state "
                                     f"for a {'flat' if not flat else 'per-leaf'} optimizer")
                opt.load_state_dict(state[name])


def apply_optimizer(opt: Optimizer, lr: float) -> None:
    """One AdamW step at ``lr`` on the parameters' ``.grad``.  A parameter
    whose ``.grad`` is None gets a zero gradient first, so it still decays,
    as every leaf of the JAX tree does.  Leaves on the CPU take torch's
    foreach AdamW.  Leaves on a card take the multi-tensor kernel
    (``kernels/adamw.py``): one launch, each leaf's step count kept and
    incremented on the device (``capturable``, which the parameter groups
    still say, as torch's capturable step would leave them), the bias
    corrections computed there, nothing read back to the host; the kernel
    raises on a leaf that is not f32, contiguous and on the first leaf's
    card.  A ``FlatAdamW`` steps as its docstring says."""
    if isinstance(opt, FlatAdamW):
        opt.step(lr)
        return
    for group in opt.param_groups:
        group["lr"] = float(lr)
        group["capturable"] = group["params"][0].is_cuda
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    if opt.param_groups[0]["params"][0].is_cuda:
        from druglamp_tpu_torch.kernels import adamw

        adamw.step(opt, float(lr))
    else:
        opt.step()
