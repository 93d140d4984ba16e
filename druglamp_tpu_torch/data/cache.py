"""Frozen-encoder embedding sources (the port's copy of ``ZeroEmbeddings`` and
``EmbeddingCache`` from ``druglamp_tpu/data/cache.py``).

``EmbeddingCache`` is a directory of one ``.npy`` per entity, written once by
the embedding pipeline and loaded once into RAM.  The file names are the JAX
package's, so a cache written by either package reads in the other.
"""

from __future__ import annotations

import os
from typing import Dict

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


class EmbeddingCache:
    """Directory of per-entity .npy arrays, preloaded into RAM."""

    def __init__(self, cache_dir: str, dataset: str,
                 n_drug_feature: int = 384, n_prot_feature: int = 640):
        self.cache_dir = cache_dir
        self.dataset = dataset
        self.n_drug_feature = n_drug_feature
        self.n_prot_feature = n_prot_feature
        self._drug: Dict[int, np.ndarray] = {}
        self._prot: Dict[int, np.ndarray] = {}

    def drug_path(self, ordinal: int) -> str:
        return os.path.join(self.cache_dir, f"{self.dataset}_{ordinal}_drug_embedded.npy")

    def prot_path(self, ordinal: int) -> str:
        return os.path.join(self.cache_dir,
                            f"{self.dataset}_{ordinal}_prot_{self.n_prot_feature}_embedded.npy")

    def has_drug(self, ordinal: int) -> bool:
        return ordinal in self._drug or os.path.exists(self.drug_path(ordinal))

    def has_prot(self, ordinal: int) -> bool:
        return ordinal in self._prot or os.path.exists(self.prot_path(ordinal))

    def put_drug(self, ordinal: int, emb: np.ndarray) -> None:
        os.makedirs(self.cache_dir, exist_ok=True)
        np.save(self.drug_path(ordinal), emb.astype(np.float32))

    def put_prot(self, ordinal: int, emb: np.ndarray) -> None:
        os.makedirs(self.cache_dir, exist_ok=True)
        np.save(self.prot_path(ordinal), emb.astype(np.float32))

    def drug(self, ordinal: int) -> np.ndarray:
        if ordinal not in self._drug:
            self._drug[ordinal] = np.load(self.drug_path(ordinal))
        return self._drug[ordinal]

    def prot(self, ordinal: int) -> np.ndarray:
        if ordinal not in self._prot:
            self._prot[ordinal] = np.load(self.prot_path(ordinal))
        return self._prot[ordinal]
