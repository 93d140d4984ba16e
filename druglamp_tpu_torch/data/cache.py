"""Frozen-encoder embedding sources (the port's copy of ``ZeroEmbeddings``,
``TableZeroEmbeddings`` and ``EmbeddingCache`` from
``druglamp_tpu/data/cache.py``), and the host form of bf16 arrays.

``EmbeddingCache`` is a directory of one ``.npy`` per entity, written once by
the embedding pipeline and loaded once into RAM.  The file names are the JAX
package's, so a cache written by either package reads in the other.

bf16 on the host: numpy has no bfloat16 of its own, so a bf16 host array is
a ``uint16`` array of bf16 bit patterns (``bf16_bits``: rounded to nearest
even, as the JAX package's ``ml_dtypes`` cast rounds), which ``bf16_tensor``
views as a ``torch.bfloat16`` tensor without a copy.  In the port's batches
and caches a ``uint16`` array always holds bf16 bits.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

BF16_HOST = np.dtype(np.uint16)      # a bf16 host array's numpy dtype


def bf16_bits(arr) -> np.ndarray:
    """A float array's values as bf16 (round to nearest even), as uint16 bit
    patterns; an array that already holds bf16 bits passes through."""
    arr = np.asarray(arr)
    if arr.dtype == BF16_HOST:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(BF16_HOST)


def bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """uint16 bf16 bit patterns → a CPU ``torch.bfloat16`` tensor over the
    same memory."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


class ZeroEmbeddings:
    """Shape-correct zero embeddings (drug (0,·) / prot (0,·) → all-pad)."""

    def __init__(self, n_drug_feature: int = 384, n_prot_feature: int = 640):
        self.n_drug_feature = n_drug_feature
        self.n_prot_feature = n_prot_feature

    def drug(self, ordinal: int) -> np.ndarray:
        return np.zeros((0, self.n_drug_feature), np.float32)

    def prot(self, ordinal: int) -> np.ndarray:
        return np.zeros((0, self.n_prot_feature), np.float32)


class TableZeroEmbeddings(ZeroEmbeddings):
    """Zero-valued embeddings at the real per-entity token lengths.

    For measurement without an on-disk cache: throughput through the device
    store depends only on shapes and gathers, not values, but all-zero
    lengths (plain ZeroEmbeddings) mask every sequence fully.  The lengths
    are those the embedding pipeline writes (``encoders/embed_pipeline.py``):
    drugs the ``SmilesTokenizer.encode`` length (CLS + tokens + SEP,
    truncated), proteins min(len, max_resis) + 2 (ESM's BOS/EOS rows)."""

    def __init__(self, drug_lens: Dict[int, int], prot_lens: Dict[int, int],
                 n_drug_feature: int = 384, n_prot_feature: int = 640):
        super().__init__(n_drug_feature, n_prot_feature)
        self._drug_lens = drug_lens
        self._prot_lens = prot_lens

    @classmethod
    def from_table(cls, table, n_drug_feature: int = 384,
                   n_prot_feature: int = 640, max_prot_resis: int = 1022,
                   max_drug_tokens: int = 512) -> "TableZeroEmbeddings":
        from druglamp_tpu_torch.chem.tokenizer import SmilesTokenizer

        tok = SmilesTokenizer()
        drug_lens = {o: len(tok.encode(smi, max_length=max_drug_tokens))
                     for smi, o in (getattr(table, "drug2ord", None) or {}).items()}
        prot_lens = {o: min(len(seq), max_prot_resis) + 2
                     for seq, o in (getattr(table, "prot2ord", None) or {}).items()}
        return cls(drug_lens, prot_lens, n_drug_feature, n_prot_feature)

    def drug(self, ordinal: int) -> np.ndarray:
        return np.zeros((self._drug_lens.get(ordinal, 0), self.n_drug_feature), np.float32)

    def prot(self, ordinal: int) -> np.ndarray:
        return np.zeros((self._prot_lens.get(ordinal, 0), self.n_prot_feature), np.float32)


class EmbeddingCache:
    """Directory of per-entity .npy arrays, preloaded into RAM.  With
    ``dtype=torch.bfloat16`` each array is converted once, at load, to bf16
    bits (``bf16_bits``), so batch assembly copies with no per-batch cast;
    without, the arrays stay as stored (f32)."""

    def __init__(self, cache_dir: str, dataset: str,
                 n_drug_feature: int = 384, n_prot_feature: int = 640,
                 dtype: Optional[torch.dtype] = None):
        self.cache_dir = cache_dir
        self.dataset = dataset
        self.n_drug_feature = n_drug_feature
        self.n_prot_feature = n_prot_feature
        self._drug: Dict[int, np.ndarray] = {}
        self._prot: Dict[int, np.ndarray] = {}
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"unsupported embedding dtype {dtype}: None or torch.bfloat16")
        self._dtype = dtype

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

    def _load(self, path: str) -> np.ndarray:
        arr = np.load(path)
        return bf16_bits(arr) if self._dtype is not None else arr

    def drug(self, ordinal: int) -> np.ndarray:
        if ordinal not in self._drug:
            self._drug[ordinal] = self._load(self.drug_path(ordinal))
        return self._drug[ordinal]

    def prot(self, ordinal: int) -> np.ndarray:
        if ordinal not in self._prot:
            self._prot[ordinal] = self._load(self.prot_path(ordinal))
        return self._prot[ordinal]
