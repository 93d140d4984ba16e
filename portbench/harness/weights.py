"""The model's weights, made on the device from the seed.

One uniform draw U(−1, 1) of every parameter entry (one call), cut into the
leaves of ``reference.model.param_shapes`` in order and scaled by a rule of
the leaf's name and shape:

- a matrix or a filter: U(±1/√fan_in), fan_in the entries of one output row
  (torch's default for Linear and Conv1d);
- the protein embedding: U(±√3), unit variance;
- a norm's scale: 1 + U(±0.1); a bias or a norm's shift: U(±0.05);
- the positional tables: U(±0.02).

BatchNorm running statistics are not weights: the program's modules start
them at 0 and 1, and the reference reads the same.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(offset, half-width) of the leaf's uniform values."""
    if name.endswith("embedding.weight"):
        return 0.0, math.sqrt(3.0)
    if name.startswith("pmma.pe_"):
        return 0.0, 0.02
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if name.endswith(".weight"):
        return 1.0, 0.1
    return 0.0, 0.05


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed + 7)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2.0).sub_(1.0)
    out = {}
    for (name, shape), piece in zip(shapes.items(), flat.split(sizes)):
        offset, width = _scale(name, shape)
        out[name] = piece.view(shape).mul(width).add_(offset)
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the program's model by name; its parameters must
    be exactly these leaves."""
    params = dict(model.named_parameters())
    if list(params) != list(weights) and set(params) != set(weights):
        raise ValueError("the program's parameters differ from the reference's: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    for k, p in params.items():
        if tuple(p.shape) != tuple(weights[k].shape):
            raise ValueError(f"{k}: the program's shape {tuple(p.shape)}, the reference's "
                             f"{tuple(weights[k].shape)}")
    names = list(params)
    torch._foreach_copy_([params[k] for k in names], [weights[k] for k in names])
