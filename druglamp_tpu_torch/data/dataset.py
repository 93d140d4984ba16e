"""Per-entity featurization records.

The port's own copy of the parts of ``druglamp_tpu/data/dataset.py`` that the
serving path needs: each drug is parsed into a compact record (node features
(n, 74) + bond edge list), each protein is integer-coded into its tiled
(seq_len,) buffer + fill boundary.  Dense adjacencies are built per batch by
the caller (``serve.Predictor._featurize``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from druglamp_tpu_torch.chem.featurize import (atom_features_matrix, repeat_integer_label_protein,
                                               warn_oversized)
from druglamp_tpu_torch.chem.smiles import parse_smiles


@dataclass
class DrugRecord:
    ordinal: int
    n_atoms: int
    node_feats: np.ndarray           # (n_atoms, 74) float32
    edges: np.ndarray                # (2, E) int32 bond list (undirected pairs, both dirs)


@dataclass
class ProtRecord:
    ordinal: int
    codes: np.ndarray                # (seq_len,) int32 tiled integer coding
    fill_start: int                  # first index of the all-zero tail


def featurize_drug(smiles: str, ordinal: int, max_nodes: int) -> DrugRecord:
    mol = parse_smiles(smiles)
    if mol.num_atoms > max_nodes:
        warn_oversized(smiles, mol.num_atoms, max_nodes)
    n = min(mol.num_atoms, max_nodes)
    feats = atom_features_matrix(mol)[:n]
    src, dst = [], []
    for bd in mol.bonds:
        if bd.a < n and bd.b < n:
            src += [bd.a, bd.b]
            dst += [bd.b, bd.a]
    edges = np.array([src, dst], dtype=np.int32) if src else np.zeros((2, 0), np.int32)
    return DrugRecord(ordinal=ordinal, n_atoms=n, node_feats=feats, edges=edges)


def featurize_prot(seq: str, ordinal: int, max_prot_resis: int, seq_len: int) -> ProtRecord:
    codes = repeat_integer_label_protein(seq, max_prot_resis, seq_len)
    trunc = seq[:max_prot_resis]
    span = len(trunc) + 2
    quot = seq_len // span if span <= seq_len else 0
    return ProtRecord(ordinal=ordinal, codes=codes, fill_start=quot * span)
