"""Model registry (port of ``druglamp_tpu/models/registry.py``)."""

from __future__ import annotations

from typing import Dict, Optional, Type

import torch

from druglamp_tpu_torch.config import Config
from druglamp_tpu_torch.models.druglamp import DrugLAMP, DrugLAMP2C2P, DrugLAMPwoLLM
from druglamp_tpu_torch.nn.inits import init_model
from druglamp_tpu_torch.parallel.mesh import MeshContext

MODEL_REGISTRY: Dict[str, Type] = {
    "DrugLAMP": DrugLAMP,
    "DrugLAMPwoLLM": DrugLAMPwoLLM,
    "DrugLAMP2C2P": DrugLAMP2C2P,
}
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_model_class(name: str) -> Type:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")


def build_model(name: str, cfg: Config, n_drug_feature: int = 384, n_prot_feature: int = 640,
                vis: bool = False, generator: Optional[torch.Generator] = None,
                bn_groups: int = 1, pmma_variant: str = "pmma",
                mesh: Optional[MeshContext] = None):
    """A fresh model on the CPU, its weights drawn from ``generator`` with the
    reference's initializers; ``bn_groups`` > 1 for per-replica BatchNorm
    statistics and CM mining (``models/base.py``); ``pmma_variant``
    ``"pmma"`` or ``"linattn"`` (``nn/pmma.py``).  Over a model axis
    (``mesh`` with ``n_model`` > 1) the whole model is drawn, as on every
    rank, and cut into this rank's pieces (``MeshContext.shard_params``)."""
    model = get_model_class(name)(n_drug_feature=n_drug_feature, n_prot_feature=n_prot_feature,
                                  config=cfg,
                                  compute_dtype=COMPUTE_DTYPES[cfg.solver.compute_dtype], vis=vis,
                                  bn_groups=bn_groups, pmma_variant=pmma_variant)
    model = init_model(model, generator)
    if mesh is not None and mesh.n_model > 1:
        mesh.shard_params(model)
    return model
