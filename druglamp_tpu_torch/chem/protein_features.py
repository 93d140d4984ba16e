"""Legacy protein features, PSSM and residue physicochemistry (port of
``druglamp_tpu/chem/protein_features.py``: the same arrays).

The reference carries a PSSM/residue-property featurization path
(utils.py:215-293: ``prot2feature``/``PSSM_calculation``/``seq_feature``/
``residue_features``) that is NOT used by the main DrugLAMP pipeline — kept
here for API completeness with identical semantics: a 21-way residue one-hot
+ 12 physicochemical descriptors per residue, and a pseudo-count PSSM from a
multiple-alignment file.
"""

from __future__ import annotations

from typing import List

import numpy as np

PROT_RES_TABLE = ["A", "C", "D", "E", "F", "G", "H", "I", "K", "L", "M", "N",
                  "P", "Q", "R", "S", "T", "V", "W", "Y", "X"]
_RES_INDEX = {r: i for i, r in enumerate(PROT_RES_TABLE)}

_ALIPHATIC = set("AILMV")
_AROMATIC = set("FWY")
_POLAR_NEUTRAL = set("CNQST")
_ACIDIC = set("DE")
_BASIC = set("HKR")

_WEIGHT = {"A": 71.08, "C": 103.15, "D": 115.09, "E": 129.12, "F": 147.18,
           "G": 57.05, "H": 137.14, "I": 113.16, "K": 128.18, "L": 113.16,
           "M": 131.20, "N": 114.11, "P": 97.12, "Q": 128.13, "R": 156.19,
           "S": 87.08, "T": 101.11, "V": 99.13, "W": 186.22, "Y": 163.18}
_PKA = {"A": 2.34, "C": 1.96, "D": 1.88, "E": 2.19, "F": 1.83, "G": 2.34,
        "H": 1.82, "I": 2.36, "K": 2.18, "L": 2.36, "M": 2.28, "N": 2.02,
        "P": 1.99, "Q": 2.17, "R": 2.17, "S": 2.21, "T": 2.09, "V": 2.32,
        "W": 2.83, "Y": 2.32}
_PKB = {"A": 9.69, "C": 10.28, "D": 9.60, "E": 9.67, "F": 9.13, "G": 9.60,
        "H": 9.17, "I": 9.60, "K": 8.95, "L": 9.60, "M": 9.21, "N": 8.80,
        "P": 10.60, "Q": 9.13, "R": 9.04, "S": 9.15, "T": 9.10, "V": 9.62,
        "W": 9.39, "Y": 9.62}
_PKX = {"A": 0.0, "C": 8.18, "D": 3.65, "E": 4.25, "F": 0.0, "G": 0.0,
        "H": 6.0, "I": 0.0, "K": 10.53, "L": 0.0, "M": 0.0, "N": 0.0,
        "P": 0.0, "Q": 0.0, "R": 12.48, "S": 0.0, "T": 0.0, "V": 0.0,
        "W": 0.0, "Y": 0.0}
_PL = {"A": 6.0, "C": 5.07, "D": 2.77, "E": 3.22, "F": 5.48, "G": 5.97,
       "H": 7.59, "I": 6.02, "K": 9.74, "L": 5.98, "M": 5.74, "N": 5.41,
       "P": 6.3, "Q": 5.65, "R": 10.76, "S": 5.68, "T": 5.6, "V": 5.96,
       "W": 5.89, "Y": 5.96}
_HYDRO_PH2 = {"A": 47, "C": 52, "D": -18, "E": 8, "F": 92, "G": 0, "H": -42,
              "I": 100, "K": -37, "L": 100, "M": 74, "N": -41, "P": -46,
              "Q": -18, "R": -26, "S": -7, "T": 13, "V": 79, "W": 84, "Y": 49}
_HYDRO_PH7 = {"A": 41, "C": 49, "D": -55, "E": -31, "F": 100, "G": 0, "H": 8,
              "I": 99, "K": -23, "L": 97, "M": 74, "N": -28, "P": -46,
              "Q": -10, "R": -14, "S": -5, "T": 13, "V": 76, "W": 97, "Y": 63}


def residue_features(residue: str) -> np.ndarray:
    """12-dim physicochemical descriptor (5 class flags + 7 scalar tables)."""
    flags = [residue in _ALIPHATIC, residue in _AROMATIC,
             residue in _POLAR_NEUTRAL, residue in _ACIDIC, residue in _BASIC]
    scalars = [t.get(residue, 0.0) for t in
               (_WEIGHT, _PKA, _PKB, _PKX, _PL, _HYDRO_PH2, _HYDRO_PH7)]
    return np.array([float(f) for f in flags] + scalars, dtype=np.float64)


def seq_feature(seq: str) -> np.ndarray:
    """(L, 33): 21-way one-hot + 12 descriptors; unknown residues map to 'X'."""
    out = np.zeros((len(seq), len(PROT_RES_TABLE) + 12))
    for i, res in enumerate(seq):
        r = res if res in _RES_INDEX else "X"
        out[i, _RES_INDEX[r]] = 1.0
        out[i, len(PROT_RES_TABLE):] = residue_features(r)
    return out


def pssm_from_alignment(aln_lines: List[str], seq: str,
                        pseudocount: float = 0.8) -> np.ndarray:
    """(21, L) pseudo-count position frequency matrix over an alignment."""
    pfm = np.zeros((len(PROT_RES_TABLE), len(seq)))
    n_lines = len(aln_lines)
    for line in aln_lines:
        if len(line) != len(seq):
            continue
        for pos, res in enumerate(line):
            if res in _RES_INDEX:
                pfm[_RES_INDEX[res], pos] += 1
    return (pfm + pseudocount / 4) / (float(n_lines) + pseudocount)


def prot_feature(aln_lines: List[str], seq: str) -> np.ndarray:
    """(L, 21 + 33) = PSSMᵀ ‖ seq_feature, the legacy combined features."""
    pssm = pssm_from_alignment(aln_lines, seq)
    return np.concatenate([pssm.T, seq_feature(seq)], axis=1)
