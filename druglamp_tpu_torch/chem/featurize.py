"""Host-side featurization to fixed-shape arrays.

Replaces the reference's RDKit/dgllife/DGL featurization path:

- ``atom_features_matrix`` mirrors dgllife ``CanonicalAtomFeaturizer`` (74-dim:
  43 atom-type one-hot, 11 degree, 7 implicit-valence, formal charge, radical
  electrons, 5 hybridization, aromatic flag, 5 total-H one-hot), used by
  reference handler/dataset.py:46.
- ``drug_graph_arrays`` reproduces the reference's padded-graph convention
  (handler/dataset.py:213-222): real atoms carry a 75th virtual-node bit = 0,
  virtual padding nodes are rows of zeros with bit = 1; the reference builds
  the graph with ``smiles_to_bigraph(add_self_loop=True)`` *and then* calls
  ``add_self_loop()`` again, so the effective adjacency is A + 2I on real
  atoms and 1·I on virtual nodes — we reproduce exactly that so the GCN's
  symmetric degree normalization matches.
- protein integer coding (``CHARPROTSET``, reference utils.py:345-412):
  residues tiled into a 9×256=2304 buffer with a 0 "CLS" slot at the start of
  each tile and a 0 "SEP" gap at the end.

This is the PyTorch port's own copy of ``druglamp_tpu/chem/featurize.py``.

Everything returns numpy; nothing here touches a framework or the device.  The dense
normalized adjacency is deliberately NOT precomputed here: the device builds
Â = n·nᵀ ⊙ A from the uint8 adjacency + degree vector (one rsqrt + outer
product), keeping host→device traffic small and the normalize step fused.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from druglamp_tpu_torch.chem.smiles import Molecule, parse_smiles

__all__ = [
    "ATOM_FEATURE_DIM",
    "ATOM_SYMBOLS",
    "atom_features_matrix",
    "drug_graph_arrays",
    "CHARPROTSET",
    "integer_label_protein",
    "repeat_integer_label_protein",
]

# dgllife CanonicalAtomFeaturizer atom-type list (43 symbols).
ATOM_SYMBOLS = [
    "C", "N", "O", "S", "F", "Si", "P", "Cl", "Br", "Mg", "Na", "Ca", "Fe",
    "As", "Al", "I", "B", "V", "K", "Tl", "Yb", "Sb", "Sn", "Ag", "Pd", "Co",
    "Se", "Ti", "Zn", "H", "Li", "Ge", "Cu", "Au", "Ni", "Cd", "In", "Mn",
    "Zr", "Cr", "Pt", "Hg", "Pb",
]
_SYMBOL_INDEX = {s: i for i, s in enumerate(ATOM_SYMBOLS)}
_HYBRIDIZATIONS = ["SP", "SP2", "SP3", "SP3D", "SP3D2"]
_HYB_INDEX = {h: i for i, h in enumerate(_HYBRIDIZATIONS)}

ATOM_FEATURE_DIM = 74  # 43 + 11 + 7 + 1 + 1 + 5 + 1 + 5


def atom_features_matrix(mol: Molecule) -> np.ndarray:
    """(num_atoms, 74) float32 canonical atom features."""
    n = mol.num_atoms
    out = np.zeros((n, ATOM_FEATURE_DIM), dtype=np.float32)
    for i, atom in enumerate(mol.atoms):
        col = 0
        idx = _SYMBOL_INDEX.get(atom.symbol)
        if idx is not None:
            out[i, idx] = 1.0
        col += 43
        if 0 <= atom.degree <= 10:
            out[i, col + atom.degree] = 1.0
        col += 11
        if 0 <= atom.implicit_h <= 6:
            out[i, col + atom.implicit_h] = 1.0
        col += 7
        out[i, col] = float(atom.charge)
        col += 1
        out[i, col] = float(atom.radical_electrons)
        col += 1
        hyb = _HYB_INDEX.get(atom.hybridization)
        if hyb is not None:
            out[i, col + hyb] = 1.0
        col += 5
        out[i, col] = 1.0 if atom.aromatic else 0.0
        col += 1
        if 0 <= atom.total_h <= 4:
            out[i, col + atom.total_h] = 1.0
    return out


def warn_oversized(smiles: str, n_atoms: int, max_nodes: int) -> None:
    """One policy for molecules over max_nodes: truncate to the first
    max_nodes atoms (dropping bonds that touch truncated atoms) and warn.
    Shared by chem.featurize.drug_graph_arrays and data.dataset.featurize_drug
    so the training path and the documented array contract agree."""
    import warnings

    warnings.warn(
        f"molecule {smiles[:40]!r}... has {n_atoms} atoms > "
        f"max_nodes={max_nodes}; truncating (the reference pre-filters its "
        f"datasets so this is out-of-distribution input)",
        RuntimeWarning, stacklevel=3)


def drug_graph_arrays(
    smiles: str,
    max_nodes: int = 512,
    mol: Optional[Molecule] = None,
) -> Dict[str, np.ndarray]:
    """Fixed-shape arrays for one drug.

    Returns a dict with:
      node_feats: (max_nodes, 75) float32 — 74 canonical dims + virtual bit.
      adj:        (max_nodes, max_nodes) uint8 — effective adjacency incl.
                  self-loop multiplicity (2 on real-atom diagonal, 1 on
                  virtual-node diagonal), matching the reference's double
                  add_self_loop (handler/dataset.py:213-222).
      degrees:    (max_nodes,) float32 — row sums of adj (sym-norm degrees).
      n_atoms:    () int32.

    Molecules larger than max_nodes are truncated to their first max_nodes
    atoms with a warning — the single oversized-molecule policy shared with
    data/dataset.py::featurize_drug (the reference would crash on the
    reshape in MolecularGCN; its shipped datasets are pre-filtered, so this
    only fires on out-of-distribution inputs).
    """
    if mol is None:
        mol = parse_smiles(smiles)
    n = mol.num_atoms
    if n > max_nodes:
        warn_oversized(smiles, n, max_nodes)
        n = max_nodes
    feats = np.zeros((max_nodes, ATOM_FEATURE_DIM + 1), dtype=np.float32)
    feats[:n, :ATOM_FEATURE_DIM] = atom_features_matrix(mol)[:n]
    feats[n:, ATOM_FEATURE_DIM] = 1.0  # virtual-node bit

    adj = np.zeros((max_nodes, max_nodes), dtype=np.uint8)
    for bd in mol.bonds:
        if bd.a < n and bd.b < n:
            adj[bd.a, bd.b] = 1
            adj[bd.b, bd.a] = 1
    idx = np.arange(max_nodes)
    adj[idx, idx] = 1            # one self-loop everywhere (virtual nodes)
    adj[idx[:n], idx[:n]] = 2    # double self-loop on real atoms

    degrees = adj.sum(axis=1).astype(np.float32)
    return {
        "node_feats": feats,
        "adj": adj,
        "degrees": degrees,
        "n_atoms": np.int32(n),
    }


# --- Protein integer coding (reference utils.py:345-412) ---------------------

CHARPROTSET: Dict[str, int] = {
    "A": 1, "C": 2, "B": 3, "E": 4, "D": 5, "G": 6, "F": 7, "I": 8, "H": 9,
    "K": 10, "M": 11, "L": 12, "O": 13, "N": 14, "Q": 15, "P": 16, "S": 17,
    "R": 18, "U": 19, "T": 20, "W": 21, "V": 22, "Y": 23, "X": 24, "Z": 25,
}
PROT_PAD_ID = 0
PROT_MASK_ID = 26
PROT_VOCAB = 27  # 25 residues + pad + mask


def integer_label_protein(sequence: str, seq_end: int, max_length: int = 9 * 256) -> np.ndarray:
    """Single-copy integer coding with a leading 0 CLS slot (utils.py:373-390)."""
    encoding = np.zeros(max_length, dtype=np.int32)
    seq = sequence[:seq_end]
    for idx, letter in enumerate(seq):
        if idx + 1 >= max_length:
            break
        encoding[idx + 1] = CHARPROTSET.get(letter.upper(), 0)
    return encoding


def repeat_integer_label_protein(sequence: str, seq_end: int, max_length: int = 9 * 256) -> np.ndarray:
    """Tile the coded sequence into the fixed buffer (utils.py:392-412).

    Each tile occupies len(seq)+2 slots: a 0 at the CLS position, the coded
    residues, and a trailing 0 SEP gap; the remainder of the buffer stays 0.
    """
    encoding = np.zeros(max_length, dtype=np.int32)
    seq = sequence[:seq_end]
    if len(seq) == 0:
        return encoding
    span = len(seq) + 2
    quot = max_length // span
    codes = np.array([CHARPROTSET.get(ch.upper(), 0) for ch in seq], dtype=np.int32)
    for i in range(quot):
        st = i * span + 1
        encoding[st : st + len(seq)] = codes
    return encoding


def tail_pad(x: np.ndarray, maxsize: int) -> np.ndarray:
    """Zero-pad (T, F) to (maxsize, F) at the tail (utils.py:304-312)."""
    t, f = x.shape[-2], x.shape[-1]
    out = np.zeros((maxsize, f), dtype=x.dtype)
    out[: min(t, maxsize)] = x[: min(t, maxsize)]
    return out


def repeat_pad(x: np.ndarray, maxsize: int) -> np.ndarray:
    """Tile (T, F) into (maxsize, F), zeros at the tail (utils.py:314-324)."""
    t, f = x.shape[-2], x.shape[-1]
    out = np.zeros((maxsize, f), dtype=x.dtype)
    quot = maxsize // t
    for j in range(quot):
        out[j * t : (j + 1) * t] = x
    return out
