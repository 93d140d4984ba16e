"""Dataset inspection (port of ``druglamp_tpu/data/inspect.py``).

``find_in_train_set`` mirrors reference utils.py:493-529: check whether a
protein sequence or drug SMILES appears in any ``*train.csv`` of a
(dataset, split).  The reference's drug comparison uses RDKit substructure
isomorphism both ways (molecule equality up to SMILES notation); here drugs
are compared by canonical graph fingerprint from the first-party parser
(atom multiset + sorted bond multiset + ring-membership-free invariants),
which catches notation-level differences like kekulized vs aromatic forms of
the same input string after parsing.
"""

from __future__ import annotations

import csv
import os
from collections import Counter
from typing import Tuple

from druglamp_tpu_torch.chem.smiles import parse_smiles


def _mol_fingerprint(smiles: str):
    """Cheap graph-invariant fingerprint: sorted atom descriptors + edge multiset."""
    mol = parse_smiles(smiles)
    atoms = sorted((a.symbol, a.charge, a.total_h, a.aromatic) for a in mol.atoms)
    labels = [(a.symbol, a.charge, a.total_h, a.aromatic) for a in mol.atoms]
    edges = Counter()
    for bd in mol.bonds:
        e = tuple(sorted((labels[bd.a], labels[bd.b]))) + (bd.order,)
        edges[e] += 1
    return (tuple(atoms), tuple(sorted(edges.items())))


def find_in_train_set(x: str, data_root: str, dataset: str, split: str,
                      label: str) -> Tuple[bool, int, int]:
    """Returns (found, rows_scanned, row_index); label ∈ {'prot', 'drug'}."""
    if label not in ("prot", "drug"):
        raise NotImplementedError(label)
    col = "Protein" if label == "prot" else "SMILES"
    file_dir = os.path.join(data_root, dataset, split)
    if not os.path.isdir(file_dir):
        raise FileNotFoundError(file_dir)
    paths = [os.path.join(file_dir, fn) for fn in sorted(os.listdir(file_dir))
             if fn.endswith("train.csv")]
    x_fp = _mol_fingerprint(x) if label == "drug" else None

    cnt = 0
    for path in paths:
        with open(path) as f:
            for idx, row in enumerate(csv.DictReader(f)):
                cnt += 1
                if label == "prot":
                    if row[col] == x:
                        return True, cnt, idx
                else:
                    if row[col] == x or _mol_fingerprint(row[col]) == x_fp:
                        return True, cnt, idx
    return False, -1, -1
