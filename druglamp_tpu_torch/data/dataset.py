"""Dataset: split CSVs → featurized entity tables + sample index (the port's
copy of ``druglamp_tpu/data/dataset.py``; ordinals and records are
bit-identical).

- CSV schema ``SMILES,Protein,Y[,drug_cluster,target_cluster]``.
- Entity ordinals come from ``full.csv`` when present, else from the union
  of the split's CSVs in order of appearance.  Ordinals are stable identity
  keys (embedding-cache file names, the device stores' rows).
- Each unique drug is parsed into a compact record (node features (n, 74) +
  bond edge list), each unique protein integer-coded into its tiled
  (seq_len,) buffer + fill boundary, once.  Adjacencies are built per batch
  (``serve.Predictor._featurize``) or packed once per drug
  (``data/device_data.py``).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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


@dataclass
class EntityTable:
    """Unique drugs/proteins of a dataset with stable ordinals."""

    drug2ord: Dict[str, int] = field(default_factory=dict)
    prot2ord: Dict[str, int] = field(default_factory=dict)
    drugs: Dict[int, DrugRecord] = field(default_factory=dict)
    prots: Dict[int, ProtRecord] = field(default_factory=dict)
    # "full" when ordinals come from full.csv (stable across splits);
    # otherwise the split name (ordinals stable only within that split)
    ordinal_scope: str = "full"

    @property
    def n_drug(self):
        return len(self.drug2ord)

    @property
    def n_prot(self):
        return len(self.prot2ord)


def _read_csv(path: str) -> List[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def build_entity_table(dataset_dir: str, split: str, max_nodes: int,
                       max_prot_resis: int, seq_len: int) -> EntityTable:
    """Assign ordinals from full.csv if present, else from the union of the
    split's CSVs; ``table.ordinal_scope`` records which."""
    table = EntityTable()
    sources: List[str] = []
    full = os.path.join(dataset_dir, "full.csv")
    if os.path.exists(full):
        sources.append(full)
        table.ordinal_scope = "full"
    else:
        table.ordinal_scope = split
        split_dir = os.path.join(dataset_dir, split)
        for fn in sorted(os.listdir(split_dir)):
            if fn.endswith(".csv"):
                sources.append(os.path.join(split_dir, fn))

    for path in sources:
        for row in _read_csv(path):
            smi, seq = row["SMILES"], row["Protein"]
            if smi not in table.drug2ord:
                table.drug2ord[smi] = len(table.drug2ord)
            if seq not in table.prot2ord:
                table.prot2ord[seq] = len(table.prot2ord)

    for smi, ordn in table.drug2ord.items():
        table.drugs[ordn] = featurize_drug(smi, ordn, max_nodes)
    for seq, ordn in table.prot2ord.items():
        table.prots[ordn] = featurize_prot(seq, ordn, max_prot_resis, seq_len)
    return table


class DTIDataset:
    """One split CSV bound to its dataset's entity table."""

    def __init__(self, data_root: str, dataset: str, split: str, csv_name: str,
                 max_nodes: int = 512, max_prot_resis: int = 1022,
                 seq_len: int = 2304, table: Optional[EntityTable] = None,
                 cutoff: Optional[int] = None):
        self.dataset = dataset
        self.split = split
        dataset_dir = os.path.join(data_root, dataset)
        self.csv_path = os.path.join(dataset_dir, split, csv_name)
        self.rows = _read_csv(self.csv_path)
        if cutoff is not None:
            self.rows = self.rows[:cutoff]
        if not self.rows:
            raise ValueError(f"empty dataset csv: {self.csv_path}")
        self.table = table if table is not None else build_entity_table(
            dataset_dir, split, max_nodes, max_prot_resis, seq_len)
        self.max_nodes = max_nodes
        self.max_prot_resis = max_prot_resis
        self.seq_len = seq_len

        self.drug_ords = np.array([self.table.drug2ord[r["SMILES"]] for r in self.rows],
                                  dtype=np.int64)
        self.prot_ords = np.array([self.table.prot2ord[r["Protein"]] for r in self.rows],
                                  dtype=np.int64)
        self.labels = np.array([float(r["Y"]) for r in self.rows], dtype=np.float32)

    def __len__(self):
        return len(self.rows)
