"""The pair library every cell reads, made from the seed.

A library file (``libraries/<name>.json``) gives the counts of a dataset
(drugs, proteins, pairs), its split, the protein lengths and the share of
positive labels.  ``make_library`` draws it:

- drugs: the real SMILES below, featurised once by the frozen parser
  (``smiles.py``) into 74 canonical atom features and a bond list, and
  repeated under the library's drug ordinals (ordinal o is SMILES o mod 37);
- proteins: seeded residue strings of the library's lengths, integer-coded
  and tiled into the model's buffer as the reference's featuriser tiles them;
- pairs: seeded (drug, protein, label) triples, cut into train / val / test;
- embeddings: seeded bf16 stand-ins for the frozen ChemBERTa and ESM-2
  tokens at the real token lengths (a drug len(SMILES) + 2 rows, a protein
  its residues + 2), zero past each entity's length, drawn on the device in
  two calls.

Everything the program is fed (the packed entity arrays, the stores) and
everything the plain reference reads (dense features, adjacency, codes) is
made here, so both sides get the same inputs and neither gets the other's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from harness.smiles import Molecule, parse_smiles

# The real drugs of the port's epoch set (chip_smoke.py's EPOCH_SMILES).
SMILES = [
    "CC(=O)OC1=CC=CC=C1C(=O)O",                                  # aspirin
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",                              # caffeine
    "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O",                             # ibuprofen
    "CC(=O)NC1=CC=C(C=C1)O",                                     # paracetamol
    "CC1=C(C=C(C=C1)NC(=O)C2=CC=C(C=C2)CN3CCN(CC3)C)NC4=NC=CC(=N4)C5=CN=CC=C5",  # imatinib
    "CN(C)C(=N)N=C(N)N",                                         # metformin
    "COC1=C(C=C2C(=C1)N=CN=C2NC3=CC(=C(C=C3)F)Cl)OCCCN4CCOCC4",  # gefitinib
    "C1=CC=C(C=C1)C2=CC(=O)C3=C(C=C(C=C3O2)O)O",                 # chrysin
    "CC(C)NCC(O)COC1=CC=CC2=CC=CC=C21",                          # propranolol
    "CN1CCC[C@H]1C2=CN=CC=C2",                                   # nicotine
    "OC(=O)CC1=CC=CC=C1NC1=C(Cl)C=CC=C1Cl",                      # diclofenac
    "CN1CCN(CC1)C2=NC3=CC=CC=C3NC4=C2C=C(C=C4)Cl",               # clozapine
    "NC(=O)C1=CC=CN=C1",                                         # nicotinamide
    "CC(C)(C)NCC(O)C1=CC(=C(C=C1)O)CO",                          # salbutamol
    "CN1C(=O)CN=C(C2=C1C=CC(=C2)Cl)C3=CC=CC=C3",                 # diazepam
    "CCN(CC)CC(=O)NC1=C(C)C=CC=C1C",                             # lidocaine
    "OC(=O)C1=CC=CC=C1O",                                        # salicylic acid
    "CC12CCC3C(C1CCC2O)CCC4=C3C=CC(=C4)O",                       # estradiol
    "CN1CCC23C4C1CC5=C2C(=C(C=C5)O)OC3C(C=C4)O",                 # morphine
    "CC(C)CC(CC(=O)O)CN",                                        # pregabalin
    "C1CCC(CC1)(CC(=O)O)CN",                                     # gabapentin
    "CC(CS)C(=O)N1CCCC1C(=O)O",                                  # captopril
    "CCOC(=O)C1=C(NC(=C(C1C2=CC=CC=C2Cl)C(=O)OC)C)COCCN",        # amlodipine
    "CN(C)CCCN1C2=CC=CC=C2CCC3=CC=CC=C31",                       # imipramine
    "CC(C)C1=C(C(=C(N1CCC(CC(CC(=O)O)O)O)C2=CC=C(C=C2)F)C3=CC=CC=C3)C(=O)NC4=CC=CC=C4",  # atorvastatin
    "CS(=O)(=O)NC1=C(C=C(C=C1)[N+](=O)[O-])OC2=CC=CC=C2",        # nimesulide
    "C1=CC=C2C(=C1)C(=CN2)CCN",                                  # tryptamine
    "CC(C)NCC(COC1=CC=C(C=C1)CC(N)=O)O",                         # atenolol
    "COC1=CC2=C(C=C1)N=C(N2)S(=O)CC3=NC=C(C(=C3C)OC)C",          # omeprazole
    "CC(C)(C)C1=CC=C(C=C1)C(O)CCCN2CCC(CC2)C(O)(C3=CC=CC=C3)C4=CC=CC=C4",  # terfenadine
    "CC(=O)NC1=NN=C(S1)S(N)(=O)=O",                              # acetazolamide
    "CN1C2CCC1CC(C2)OC(=O)C(CO)C3=CC=CC=C3",                     # atropine
    "O=C1NC(=O)C(N1)(c1ccccc1)c1ccccc1",                         # phenytoin
    "CN1C=NC(=C1SC2=NC=NC3=C2NC=N3)[N+](=O)[O-]",                # azathioprine
    "CC(=O)CC(C1=CC=CC=C1)C2=C(C3=CC=CC=C3OC2=O)O",              # warfarin
    "CNCCC(C1=CC=CC=C1)OC2=CC=C(C=C2)C(F)(F)F",                  # fluoxetine
    "CC1=NN=C2N1C3=C(C=C(C=C3)Cl)C(=NC2)C4=CC=CC=C4",            # alprazolam
]

AMINO = "ACDEFGHIKLMNPQRSTVWY"
# The reference's protein vocabulary (its utils.py CHARPROTSET); 0 pads, 26 masks.
CHARPROTSET = {
    "A": 1, "C": 2, "B": 3, "E": 4, "D": 5, "G": 6, "F": 7, "I": 8, "H": 9,
    "K": 10, "M": 11, "L": 12, "O": 13, "N": 14, "Q": 15, "P": 16, "S": 17,
    "R": 18, "U": 19, "T": 20, "W": 21, "V": 22, "Y": 23, "X": 24, "Z": 25,
}

# dgllife's CanonicalAtomFeaturizer: 43 atom types, 11 degrees, 7 implicit
# valences, charge, radical electrons, 5 hybridizations, aromatic, 5 H counts.
ATOM_SYMBOLS = [
    "C", "N", "O", "S", "F", "Si", "P", "Cl", "Br", "Mg", "Na", "Ca", "Fe",
    "As", "Al", "I", "B", "V", "K", "Tl", "Yb", "Sb", "Sn", "Ag", "Pd", "Co",
    "Se", "Ti", "Zn", "H", "Li", "Ge", "Cu", "Au", "Ni", "Cd", "In", "Mn",
    "Zr", "Cr", "Pt", "Hg", "Pb",
]
HYBRIDIZATIONS = ["SP", "SP2", "SP3", "SP3D", "SP3D2"]
ATOM_FEATURES = 74


def atom_features(mol: Molecule) -> np.ndarray:
    """(atoms, 74) f32 canonical atom features."""
    out = np.zeros((mol.num_atoms, ATOM_FEATURES), np.float32)
    for i, atom in enumerate(mol.atoms):
        if atom.symbol in ATOM_SYMBOLS:
            out[i, ATOM_SYMBOLS.index(atom.symbol)] = 1.0
        if 0 <= atom.degree <= 10:
            out[i, 43 + atom.degree] = 1.0
        if 0 <= atom.implicit_h <= 6:
            out[i, 54 + atom.implicit_h] = 1.0
        out[i, 61] = float(atom.charge)
        out[i, 62] = float(atom.radical_electrons)
        if atom.hybridization in HYBRIDIZATIONS:
            out[i, 63 + HYBRIDIZATIONS.index(atom.hybridization)] = 1.0
        out[i, 68] = 1.0 if atom.aromatic else 0.0
        if 0 <= atom.total_h <= 4:
            out[i, 69 + atom.total_h] = 1.0
    return out


def drug_graphs(smiles, max_nodes: int):
    """The drugs as dense arrays: node features (n, N, 75) f32 (the 75th
    column marks virtual padding nodes), the effective adjacency (n, N, N)
    uint8 (bonds, 2 on a real atom's diagonal, 1 on a virtual node's: the
    reference adds a self-loop twice) and the atom counts (n,)."""
    n = len(smiles)
    feats = np.zeros((n, max_nodes, ATOM_FEATURES + 1), np.float32)
    adj = np.zeros((n, max_nodes, max_nodes), np.uint8)
    atoms = np.zeros(n, np.int32)
    diag = np.arange(max_nodes)
    for i, s in enumerate(smiles):
        mol = parse_smiles(s)
        k = min(mol.num_atoms, max_nodes)
        feats[i, :k, :ATOM_FEATURES] = atom_features(mol)[:k]
        feats[i, k:, ATOM_FEATURES] = 1.0
        for bd in mol.bonds:
            if bd.a < k and bd.b < k:
                adj[i, bd.a, bd.b] = adj[i, bd.b, bd.a] = 1
        adj[i, diag, diag] = 1
        adj[i, diag[:k], diag[:k]] = 2
        atoms[i] = k
    return feats, adj, atoms


def protein_codes(residues: np.ndarray, lengths: np.ndarray, seq_len: int):
    """Integer-code and tile each protein into its (seq_len,) buffer as the
    reference's ``repeat_integer_label_protein`` does: tiles of len + 2
    slots (a 0 before the residues, a 0 after), as many whole tiles as fit,
    zeros after them → (codes (n, seq_len) uint8, fill start (n,) int32:
    the first slot of the zero tail).  ``residues`` (n, max_len) holds
    CHARPROTSET codes; row i's first ``lengths[i]`` are the protein."""
    pos = np.arange(seq_len)[None, :]
    span = lengths[:, None].astype(np.int64) + 2
    quot = seq_len // span
    j = pos % span
    inside = (pos < quot * span) & (j >= 1) & (j <= span - 2)
    col = np.clip(j - 1, 0, residues.shape[1] - 1)
    codes = np.where(inside, np.take_along_axis(residues, col, axis=1), 0).astype(np.uint8)
    return codes, (quot[:, 0] * span[:, 0]).astype(np.int32)


def pack_bits(binary: np.ndarray) -> np.ndarray:
    """(…, N) {0, 1} → (…, N/8) uint8 in the program's group-64 layout: byte c
    holds bit g for column g·(N/8) + c."""
    *lead, N = binary.shape
    bb = binary.reshape(*lead, 8, N // 8).astype(np.uint8)
    shifts = np.arange(8, dtype=np.uint8).reshape(8, 1)
    return np.bitwise_or.reduce(bb << shifts, axis=-2)


def pack_node_features(feats: np.ndarray):
    """(…, 75) → ((…, 10) uint8, the 73 binary columns packed; (…, 2) int8,
    charge and radical electrons): the program's compact node features."""
    ints = feats[..., [61, 62]]
    binary = np.delete(feats, [61, 62], axis=-1)
    binary = np.concatenate([binary, np.zeros(binary.shape[:-1] + (80 - binary.shape[-1],),
                                              binary.dtype)], axis=-1)
    return pack_bits((binary > 0).astype(np.uint8)), np.rint(ints).astype(np.int8)


@dataclass
class Library:
    """What a run reads.  Host arrays are the reference's; ``entities``,
    ``pairs`` and ``store`` are on the device, in the program's formats."""
    n_drug: int
    n_prot: int
    drug_smiles: np.ndarray        # (n_drug,) index into SMILES
    drug_feats: np.ndarray         # (37, N, 75) f32, per unique SMILES
    drug_adj: np.ndarray           # (37, N, N) uint8
    drug_atoms: np.ndarray         # (37,)
    prot_codes: np.ndarray         # (n_prot, seq_len) uint8
    prot_fill: np.ndarray          # (n_prot,) int32
    pair_drug: np.ndarray          # (n_pairs,) int32
    pair_prot: np.ndarray
    pair_label: np.ndarray         # (n_pairs,) f32
    splits: Dict[str, np.ndarray]  # name → pair indices
    entities: Dict[str, torch.Tensor]
    store: Dict[str, torch.Tensor]

    def pairs(self, split: str, device) -> Dict[str, torch.Tensor]:
        """The split's pair arrays on the device (the program's names)."""
        ids = self.splits[split]
        return {"pair_drug": torch.from_numpy(self.pair_drug[ids]).to(device),
                "pair_prot": torch.from_numpy(self.pair_prot[ids]).to(device),
                "pair_label": torch.from_numpy(self.pair_label[ids]).to(device)}


def make_library(spec: dict, cfg: dict, seed: int, device) -> Library:
    rng = np.random.default_rng([seed, 1])
    n_drug, n_prot, n_pairs = spec["drugs"], spec["proteins"], spec["pairs"]
    N, L = cfg["max_nodes"], cfg["seq_len"]
    lo, hi = spec["protein_residues"]
    hi = min(hi, cfg["max_resis"])

    feats, adj, atoms = drug_graphs(SMILES, N)
    drug_smiles = np.arange(n_drug) % len(SMILES)
    lengths = rng.integers(lo, hi + 1, size=n_prot)
    codes_of = np.array([CHARPROTSET[a] for a in AMINO], np.uint8)
    residues = codes_of[rng.integers(0, len(AMINO), size=(n_prot, hi))]
    prot_codes, prot_fill = protein_codes(residues, lengths, L)

    pair_drug = rng.integers(0, n_drug, size=n_pairs).astype(np.int32)
    pair_prot = rng.integers(0, n_prot, size=n_pairs).astype(np.int32)
    pair_label = (rng.random(n_pairs) < spec["positive_share"]).astype(np.float32)
    order = rng.permutation(n_pairs)
    cuts = np.cumsum([int(round(f * n_pairs)) for f in spec["split"]])[:-1]
    splits = dict(zip(("train", "val", "test"), np.split(order, cuts)))
    splits["all"] = np.arange(n_pairs)

    # the program's compact entity arrays, built per unique SMILES and
    # repeated on the device
    bits, ints = pack_node_features(feats)
    binary_adj = (adj > 0).astype(np.uint8)          # the real atoms' second loop is implicit
    sel = torch.from_numpy(drug_smiles).to(device)

    def per_drug(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device).index_select(0, sel)

    entities = {"node_bits": per_drug(bits), "node_ints": per_drug(ints),
                "adj_packed": per_drug(pack_bits(binary_adj)), "n_atoms": per_drug(atoms),
                "vp": torch.from_numpy(prot_codes).to(device),
                "p_fill_start": torch.from_numpy(prot_fill).to(device)}

    # frozen-encoder stand-ins: bf16 N(0, 1) at the real token lengths
    g = torch.Generator(device=device).manual_seed(seed)
    smiles_len = np.array([len(s) + 2 for s in SMILES])
    drug_len = torch.from_numpy(np.minimum(smiles_len[drug_smiles], N).astype(np.int32))
    prot_len = torch.from_numpy((np.minimum(lengths, cfg["max_resis"]) + 2).astype(np.int32))
    max_prot = cfg["max_resis"] + 2
    drug_emb = torch.randn((n_drug, N, cfg["drug_llm_dim"]), generator=g, device=device,
                           dtype=torch.bfloat16)
    prot_emb = torch.randn((n_prot, max_prot, cfg["prot_llm_dim"]), generator=g, device=device,
                           dtype=torch.bfloat16)
    drug_len, prot_len = drug_len.to(device), prot_len.to(device)
    drug_emb.mul_((torch.arange(N, device=device)[None, :] < drug_len[:, None])[..., None])
    prot_emb.mul_((torch.arange(max_prot, device=device)[None, :] < prot_len[:, None])[..., None])
    store = {"drug_emb": drug_emb, "drug_len": drug_len, "prot_emb": prot_emb,
             "prot_len": prot_len}
    return Library(n_drug, n_prot, drug_smiles, feats, adj, atoms, prot_codes, prot_fill,
                   pair_drug, pair_prot, pair_label, splits, entities, store)
