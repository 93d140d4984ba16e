"""Device-resident frozen-embedding store (port of
``druglamp_tpu/data/device_store.py``).

The frozen ChemBERTa/ESM-2 embeddings are per-entity constants.  Instead of
shipping them with every sample, each unique entity's embedding is uploaded
once, bf16, into (n_entities, max_len, F) arrays on the device; a batch then
carries int32 ordinals and the step gathers on the device
(``decode_batch(..., store)`` or the epoch's hoisted gather).
``budget_bytes`` guards large datasets: over budget ``build`` returns None
and the caller keeps host-shipped embeddings.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from druglamp_tpu_torch.data.cache import BF16_HOST, bf16_tensor
from druglamp_tpu_torch.serve import resolve_device


class DeviceEmbeddingStore:
    """Entity-ordinal-indexed embedding tensors on the device; ``.tree`` is
    the dict the steps take."""

    def __init__(self, drug_emb, drug_len, prot_emb, prot_len):
        self.tree = {"drug_emb": drug_emb, "drug_len": drug_len,
                     "prot_emb": prot_emb, "prot_len": prot_len}

    @staticmethod
    def estimate_bytes(table, cache, max_drug_tokens: int, max_prot_len: int) -> int:
        nd, npf = cache.n_drug_feature, cache.n_prot_feature
        return 2 * (table.n_drug * max_drug_tokens * nd
                    + table.n_prot * max_prot_len * npf)

    @classmethod
    def build(cls, table, cache, max_drug_tokens: int = 512, max_prot_len: int = 1024,
              budget_bytes: int = 8 << 30, device="cuda") -> Optional["DeviceEmbeddingStore"]:
        """Assemble on the host in bf16 (rounded to nearest even, as the JAX
        package's ml_dtypes cast) and upload to ``device``; None when the
        store would exceed ``budget_bytes``.  Rows past an entity's length
        are zero; longer embeddings are cut to the store's length.  A cache
        in bf16 host form (uint16 bits, ``EmbeddingCache(dtype=torch.bfloat16)``)
        is taken as it is."""
        dev = resolve_device(device)
        if cls.estimate_bytes(table, cache, max_drug_tokens, max_prot_len) > budget_bytes:
            return None

        def stack(n: int, length: int, width: int, get):
            emb = torch.zeros((n, length, width), dtype=torch.bfloat16)
            lens = torch.zeros((n,), dtype=torch.int32)
            for o in range(n):
                e = np.asarray(get(o))
                t = min(e.shape[0], length)
                emb[o, :t] = (bf16_tensor(e[:t]) if e.dtype == BF16_HOST
                              else torch.from_numpy(np.asarray(e[:t], dtype=np.float32)))
                lens[o] = t
            return emb.to(dev), lens.to(dev)

        drug_emb, drug_len = stack(table.n_drug, max_drug_tokens, cache.n_drug_feature,
                                   cache.drug)
        prot_emb, prot_len = stack(table.n_prot, max_prot_len, cache.n_prot_feature,
                                   cache.prot)
        return cls(drug_emb, drug_len, prot_emb, prot_len)
