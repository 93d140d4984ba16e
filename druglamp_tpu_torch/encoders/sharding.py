"""Tensor-parallel sharding of the frozen ESM-2 encoder (port of
``druglamp_tpu/encoders/sharding.py``).

The JAX package gives ESM-2's Dense kernels logical axis names
(``encoders/esm2.py``: ``model_heads`` on Q/K/V's columns and ``out_proj``'s
rows, ``model_ffn`` on ``fc1``'s columns and ``fc2``'s rows) and maps both
onto the mesh's ``model`` axis.  Here the same split is explicit
(``ESM_RULES``, applied by ``parallel/mesh.py::MeshContext.shard_params``):
each rank of a model group holds H/M whole heads and FFN/M hidden units, an
input goes through ``copy_to_model`` before Q/K/V and before ``fc1``, and
``out_proj`` and ``fc2`` reduce their partial products over the model ranks
(one reduce each).

Only the boxed parameters of a fresh random init carry the logical names in
JAX, so a converted checkpoint runs replicated there; ``shard_encoder`` is
called, as the JAX package shards, only for a seeded random init
(``encoders/embed_pipeline.py``).
"""

from __future__ import annotations

from typing import Dict

import torch

from druglamp_tpu_torch.parallel.mesh import COLUMN, ROW, MeshContext

ESM_RULES = (
    (r"(^|\.)self_attn$", "ESMSelfAttention", "num_heads",
     {f"{p}_proj.{w}": COLUMN for p in "qkv" for w in ("weight", "bias")}
     | {"out_proj.weight": ROW}),
    (r"^layers\.\d+$", "ESMLayer", "fc1.out_features",
     {"fc1.weight": COLUMN, "fc1.bias": COLUMN, "fc2.weight": ROW}),
)


def shard_encoder(model: torch.nn.Module, mesh: MeshContext) -> Dict[str, str]:
    """Cut a whole ESM-2 into this model rank's pieces → {name: how it split}
    (empty with one model rank)."""
    return mesh.shard_params(model, ESM_RULES)
