"""Initializers matching the torch defaults the reference trains with, drawn
from an explicit ``torch.Generator`` (the port's counterpart of
``druglamp_tpu/nn/inits.py``; used only for a fresh model — weights carried
over from JAX go through ``convert.from_jax_params``).

Weights are torch-layout: Linear ``(out, in)``, Conv1d ``(out, in, k)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def uniform_(t: torch.Tensor, bound: float, g: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=g)


def normal_(t: torch.Tensor, std: float, g: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=g)


def fan_in_bound(fan_in: int) -> float:
    """torch Linear/Conv1d default: U(-1/√fan_in, 1/√fan_in) for weight and bias."""
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


def torch_linear_(w: torch.Tensor, g: Optional[torch.Generator]) -> torch.Tensor:
    """(out, in) or (out, in, k) weight: fan_in is everything but dim 0."""
    return uniform_(w, fan_in_bound(w[0].numel()), g)


def xavier_uniform_(w: torch.Tensor, g: Optional[torch.Generator]) -> torch.Tensor:
    fan_out, fan_in = w.shape
    return uniform_(w, math.sqrt(6.0 / (fan_in + fan_out)), g)


def init_model(model: nn.Module, g: Optional[torch.Generator]) -> nn.Module:
    """Re-initialize every parameter from ``g``: each module with an
    ``init_weights(g)`` method draws its own direct parameters, in
    ``model.modules()`` order (deterministic for a given seed)."""
    for m in model.modules():
        fn = getattr(m, "init_weights", None)
        if fn is not None:
            fn(g)
    return model
