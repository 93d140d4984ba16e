"""Weight bridge: the JAX package's flax trees → the port's ``state_dict``,
and back (``to_jax_paths``, for comparing gradients and updated parameters
leaf by leaf with the JAX step).

The flax trees (``params``, ``batch_stats``) come in as nested dicts of numpy
arrays.  A leaf's flax path, joined with ``/`` (e.g.
``drug_extractor/layer_0/graph_kernel``), maps to one ``state_dict`` key:

- dense ``kernel`` (in, out) → ``weight`` (out, in); conv ``kernel``
  (k, in, out) → ``weight`` (out, in, k);
- LayerNorm / BatchNorm ``scale`` → ``weight``; BatchNorm ``{mean, var}`` from
  batch_stats → ``running_mean`` / ``running_var``; the ``BatchNorm_0`` level
  of the flax path is dropped (the cross-modality head's ``MaskedBatchNorm``
  has none; SimSiam's affine-free ``bn3`` has stats and no parameters);
- GCN ``graph_kernel`` / ``graph_bias`` → ``graph.weight`` (transposed) /
  ``graph.bias``; ``init_transform`` → ``init_transform.weight`` (transposed);
  ``embedding`` → ``embedding.weight``; GCA ``in_proj_weight`` (E, 3E) →
  torch MultiheadAttention's (3E, E).

Every leaf of the trees is mapped, the SSL and CM heads' included: a flax
leaf the model lacks, or a model key left unfilled, raises.

The frozen encoders' trees (``druglamp_tpu/encoders/{esm2,chemberta}.py``)
map by ``from_jax_encoder_params``: ``layer_{i}`` → ``layers.{i}``, dense
``kernel`` → ``weight`` (transposed), LayerNorm ``scale`` and an Embed's
``embedding`` → ``weight``, anything else (a bias, ChemBERTa's
``token_type_embedding``) by its own name.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from druglamp_tpu_torch.nn.layers import MaskedBatchNorm, TorchBatchNorm


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


# flax leaf name → (state_dict key tail, transpose?)
_LEAF_RENAMES = {
    "scale": ("weight", False),
    "graph_kernel": ("graph.weight", True),
    "graph_bias": ("graph.bias", False),
    "init_transform": ("init_transform.weight", True),
    "in_proj_weight": ("in_proj_weight", True),
    "embedding": ("embedding.weight", False),
    "mean": ("running_mean", False),
    "var": ("running_var", False),
}


def _map_leaf(path: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    *head, leaf = [p for p in path.split("/") if p != "BatchNorm_0"]
    if leaf == "kernel":
        tail = "weight"
        value = value.T if value.ndim == 2 else value.transpose(2, 1, 0)
    else:
        tail, transpose = _LEAF_RENAMES.get(leaf, (leaf, False))
        value = value.T if transpose else value
    return ".".join(head + [tail]), value


def from_jax_params(params: Mapping, batch_stats: Mapping, model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """→ the state_dict for ``model``.  Raises ``KeyError`` on a flax leaf the
    model has no key for, or a model key left unfilled, and ``ValueError`` on
    a shape mismatch."""
    return _state_from_leaves({**_flatten(params), **_flatten(batch_stats)}, model, _map_leaf)


def _map_encoder_leaf(path: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    *head, leaf = [re.sub(r"^layer_(\d+)$", r"layers.\1", p) for p in path.split("/")]
    if leaf == "kernel":
        return ".".join(head + ["weight"]), value.T
    return ".".join(head + ["weight" if leaf in ("scale", "embedding") else leaf]), value


def from_jax_encoder_params(params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """An encoder's flax params (ESM2 or ChemBERTa) → the state dict of the
    port's module; raises as ``from_jax_params`` does."""
    return _state_from_leaves(_flatten(params), model, _map_encoder_leaf)


def _state_from_leaves(leaves: Mapping[str, np.ndarray], model: nn.Module,
                       map_leaf: Callable[[str, np.ndarray], Tuple[str, np.ndarray]]
                       ) -> Dict[str, torch.Tensor]:
    expected = model.state_dict()
    state: Dict[str, torch.Tensor] = {}
    for path, value in leaves.items():
        key, value = map_leaf(path, value)
        if key not in expected:
            raise KeyError(f"flax leaf {path!r} maps to {key!r}, which the model does not have")
        tensor = torch.tensor(np.asarray(value, dtype=np.float32))
        if tuple(tensor.shape) != tuple(expected[key].shape):
            raise ValueError(f"{path!r}: shape {tuple(tensor.shape)} != model "
                             f"{key!r} {tuple(expected[key].shape)}")
        state[key] = tensor
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"model keys missing from the flax trees: {missing}")
    return state


def to_jax_paths(tensors: Mapping[str, torch.Tensor], model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of ``from_jax_params``'s leaf map: a dict keyed like
    ``model.state_dict()`` (the state dict itself, or the parameters'
    ``.grad``s) → {flax path joined with ``/``: f32 numpy array in flax
    layout}.  A BatchNorm's leaves regain their ``BatchNorm_0`` level (a
    MaskedBatchNorm's have none); the model tells its weight and bias from a
    LayerNorm's or a Dense's."""
    norms = {name for name, m in model.named_modules() if isinstance(m, TorchBatchNorm)}
    masked = {name for name, m in model.named_modules() if isinstance(m, MaskedBatchNorm)}
    norm_leaves = {"weight": "scale", "running_mean": "mean", "running_var": "var"}
    dotted = {tail: (leaf, t) for leaf, (tail, t) in _LEAF_RENAMES.items() if "." in tail}
    out: Dict[str, np.ndarray] = {}
    for key, tensor in tensors.items():
        value = tensor.detach().cpu().float().numpy()
        owner, _, tail = key.rpartition(".")
        head = owner.split(".") if owner else []
        last_two = ".".join(key.split(".")[-2:])
        if owner in norms:
            path = head + ["BatchNorm_0", norm_leaves.get(tail, tail)]
        elif owner in masked:
            path = head + [norm_leaves.get(tail, tail)]
        elif last_two in dotted:                            # graph / init_transform / embedding
            leaf, transpose = dotted[last_two]
            path, value = head[:-1] + [leaf], (value.T if transpose else value)
        elif tail == "weight":      # Dense (out, in) / conv (out, in, k) kernel, LayerNorm scale
            path, value = head + ["kernel" if value.ndim > 1 else "scale"], value.T
        else:
            path = head + [tail]
            value = value.T if _LEAF_RENAMES.get(tail, (tail, False))[1] else value
        out["/".join(path)] = np.array(value)            # a copy: the model updates in place
    return out
