"""Frozen-encoder embedding sources (the port's copy of ``ZeroEmbeddings``
from ``druglamp_tpu/data/cache.py``)."""

from __future__ import annotations

import numpy as np


class ZeroEmbeddings:
    """Shape-correct zero embeddings (drug (0,·) / prot (0,·) → all-pad)."""

    def __init__(self, n_drug_feature: int = 384, n_prot_feature: int = 640):
        self.n_drug_feature = n_drug_feature
        self.n_prot_feature = n_prot_feature

    def drug(self, ordinal: int) -> np.ndarray:
        return np.zeros((0, self.n_drug_feature), np.float32)

    def prot(self, ordinal: int) -> np.ndarray:
        return np.zeros((0, self.n_prot_feature), np.float32)
