"""Dataset partitioning (port of ``druglamp_tpu/data/partition.py``; reference
utils.py:23-73 ``partition_data``): the same seed gives the same splits.

Two split modes over a (Drug_ID, Protein, Y) table:
- 'drug': unique drugs are partitioned so no drug appears in two splits
  (cold-start on the drug side),
- 'pair': DeepDTA-style random split on interaction pairs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def partition_data(data_splits: Sequence[float], drug_ids: Sequence[str],
                   kind: str = "drug", seed: int = 0
                   ) -> Tuple[Dict, Dict, Dict, int]:
    """Returns (train, valid, test, n_unique_drugs); each split dict has
    'drugs' (unique drug ids) and 'ids' (row indices)."""
    assert abs(sum(data_splits) - 1.0) < 1e-9, "data_splits should sum to 1"
    rng = np.random.RandomState(seed)
    drug_ids = list(drug_ids)
    uniq = list(dict.fromkeys(drug_ids))
    n_drug = len(uniq)

    rows_of: Dict[str, List[int]] = {}
    for i, d in enumerate(drug_ids):
        rows_of.setdefault(d, []).append(i)

    if kind == "drug":
        order = rng.permutation(n_drug)
        n_train = int(round(n_drug * data_splits[0]))
        n_valid = int(round(n_drug * data_splits[1]))
        groups = [order[:n_train], order[n_train:n_train + n_valid],
                  order[n_train + n_valid:]]
        out = []
        for g in groups:
            drugs = [uniq[i] for i in g]
            ids = [r for d in drugs for r in rows_of[d]]
            out.append({"drugs": drugs, "ids": ids})
        return out[0], out[1], out[2], n_drug

    if kind == "pair":
        n = len(drug_ids)
        ids = rng.permutation(n)
        n_train = int(round(n * data_splits[0]))
        n_valid = int(round(n * data_splits[1]))
        chunks = [ids[:n_train], ids[n_train:n_train + n_valid],
                  ids[n_train + n_valid:]]
        out = [{"ids": list(c),
                "drugs": list(dict.fromkeys(drug_ids[i] for i in c))}
               for c in chunks]
        return out[0], out[1], out[2], n_drug

    raise ValueError(f"unknown partition kind {kind!r}")
