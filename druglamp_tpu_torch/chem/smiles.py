"""First-party SMILES parser.

The reference delegates SMILES → molecular graph to RDKit (C++) through
dgllife's ``smiles_to_bigraph`` + ``CanonicalAtomFeaturizer``
(reference handler/dataset.py:46-48,213).  RDKit is not a dependency of this
framework; this module implements the subset of molecular perception the
DrugLAMP featurization actually needs:

- atoms (organic subset + bracket atoms: isotope, charge, explicit H count),
- bonds (single/double/triple/aromatic; stereo markers parsed and ignored),
- ring closures (single digit and ``%nn``), branches,
- implicit hydrogen counting per the Daylight valence model,
- aromaticity from input annotation (lowercase / ``:`` bonds),
- a hybridization heuristic (SP/SP2/SP3) sufficient for the 5-way one-hot.

This is the PyTorch port's own copy of ``druglamp_tpu/chem/smiles.py`` (the
port imports nothing of the JAX package); the tests hold the two to
bit-identical featurizations.

Exact RDKit parity (kekulization, aromaticity re-perception, sanitization) is
out of scope: the framework trains from scratch with its own consistent
featurization, which is what matters for end-task AUROC.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Atom", "Bond", "Molecule", "parse_smiles", "SmilesError"]


class SmilesError(ValueError):
    pass


# Daylight default valences for the organic subset (implicit-H model).
_DEFAULT_VALENCES: Dict[str, Tuple[int, ...]] = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
}

# Two-letter organic-subset symbols that may appear unbracketed.
_ORGANIC_TWO = ("Cl", "Br")
_ORGANIC_ONE = set("BCNOPSFI")
_AROMATIC_ORGANIC = set("bcnops")

# All element symbols (for bracket atoms), longest-first matching.
_ELEMENTS = [
    "He", "Li", "Be", "Ne", "Na", "Mg", "Al", "Si", "Cl", "Ar", "Ca", "Sc",
    "Ti", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se",
    "Br", "Kr", "Rb", "Sr", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag",
    "Cd", "In", "Sn", "Sb", "Te", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf",
    "Ta", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At",
    "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "Np", "Pu", "Am", "Cm", "Bk", "Cf",
    "Es", "Fm", "Md", "No", "Lr",
    "H", "B", "C", "N", "O", "F", "P", "S", "K", "V", "Y", "I", "W", "U",
]
_ELEMENTS.sort(key=len, reverse=True)

_BOND_ORDERS = {"-": 1.0, "=": 2.0, "#": 3.0, "$": 4.0, ":": 1.5, "/": 1.0, "\\": 1.0}


@dataclass
class Atom:
    symbol: str
    aromatic: bool = False
    charge: int = 0
    explicit_h: Optional[int] = None   # from bracket; None = implicit model
    isotope: int = 0
    smiles_pos: int = -1               # char offset of the symbol in the SMILES string
    smiles_end: int = -1               # one past last char of the symbol
    # perception results (filled by _perceive):
    degree: int = 0                    # explicit connections (bonds to other atoms)
    implicit_h: int = 0
    total_h: int = 0
    radical_electrons: int = 0
    hybridization: str = "SP3"         # one of S, SP, SP2, SP3, SP3D, SP3D2
    in_ring: bool = False


@dataclass
class Bond:
    a: int
    b: int
    order: float                       # 1, 2, 3, 4 or 1.5 (aromatic)
    aromatic: bool = False
    in_ring: bool = False


@dataclass
class Molecule:
    atoms: List[Atom] = field(default_factory=list)
    bonds: List[Bond] = field(default_factory=list)
    smiles: str = ""

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    def neighbors(self, i: int) -> List[int]:
        out = []
        for bd in self.bonds:
            if bd.a == i:
                out.append(bd.b)
            elif bd.b == i:
                out.append(bd.a)
        return out


def _match_element(s: str, i: int) -> Optional[str]:
    for el in _ELEMENTS:
        if s.startswith(el, i):
            return el
    return None


def _parse_bracket(s: str, i: int, mol: Molecule) -> Tuple[Atom, int]:
    """Parse a bracket atom starting at s[i] == '['; returns (atom, index past ']')."""
    j = i + 1
    isotope = 0
    while j < len(s) and s[j].isdigit():
        isotope = isotope * 10 + int(s[j])
        j += 1
    aromatic = False
    # aromatic bracket symbols: c, n, o, p, s, se, as, b, te, si
    sym = None
    for cand in ("se", "as", "te", "si"):
        if s.startswith(cand, j):
            sym = cand.capitalize() if cand in ("se", "te", "si") else "As"
            aromatic = True
            j += 2
            break
    if sym is None and j < len(s) and s[j] in "bcnops":
        sym = s[j].upper()
        aromatic = True
        j += 1
    if sym is None:
        el = _match_element(s, j)
        if el is None:
            if j < len(s) and s[j] == "*":
                el = "*"
            else:
                raise SmilesError(f"bad bracket atom in {s!r} at {i}")
        sym = el
        j += len(el)
    sym_pos = j - len(sym)
    # chirality
    while j < len(s) and s[j] == "@":
        j += 1
    if j < len(s) and s.startswith("TH", j):
        j += 2
    # explicit hydrogens
    explicit_h = 0
    if j < len(s) and s[j] == "H":
        j += 1
        explicit_h = 1
        if j < len(s) and s[j].isdigit():
            explicit_h = int(s[j])
            j += 1
    # charge
    charge = 0
    while j < len(s) and s[j] in "+-":
        sign = 1 if s[j] == "+" else -1
        j += 1
        if j < len(s) and s[j].isdigit():
            n = 0
            while j < len(s) and s[j].isdigit():
                n = n * 10 + int(s[j])
                j += 1
            charge += sign * n
        else:
            charge += sign
    # atom-map class
    if j < len(s) and s[j] == ":":
        j += 1
        while j < len(s) and s[j].isdigit():
            j += 1
    if j >= len(s) or s[j] != "]":
        raise SmilesError(f"unterminated bracket atom in {s!r} at {i}")
    atom = Atom(symbol=sym, aromatic=aromatic, charge=charge, explicit_h=explicit_h,
                isotope=isotope, smiles_pos=sym_pos, smiles_end=sym_pos + len(sym))
    return atom, j + 1


def parse_smiles(s: str) -> Molecule:
    """Parse a SMILES string into a Molecule with perceived properties."""
    mol = Molecule(smiles=s)
    stack: List[int] = []
    prev: int = -1
    pending_bond: Optional[float] = None
    ring_open: Dict[int, Tuple[int, Optional[float]]] = {}
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "[":
            atom, i = _parse_bracket(s, i, mol)
            idx = _add_atom(mol, atom, prev, pending_bond)
            prev, pending_bond = idx, None
        elif c in _BOND_ORDERS:
            if pending_bond is not None and c not in "/\\":
                raise SmilesError(f"double bond symbol in {s!r} at {i}")
            pending_bond = _BOND_ORDERS[c]
            i += 1
        elif c == "(":
            if prev < 0:
                raise SmilesError(f"branch with no prior atom in {s!r} at {i}")
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError(f"unbalanced ')' in {s!r} at {i}")
            prev = stack.pop()
            i += 1
        elif c == ".":
            prev = -1
            pending_bond = None
            i += 1
        elif c.isdigit() or c == "%":
            if c == "%":
                if i + 2 >= n or not (s[i + 1].isdigit() and s[i + 2].isdigit()):
                    raise SmilesError(f"bad %ring closure in {s!r} at {i}")
                num = int(s[i + 1 : i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            if prev < 0:
                raise SmilesError(f"ring closure with no prior atom in {s!r}")
            if num in ring_open:
                other, opened_bond = ring_open.pop(num)
                order = pending_bond if pending_bond is not None else opened_bond
                if order is None:
                    if mol.atoms[prev].aromatic and mol.atoms[other].aromatic:
                        order = 1.5
                    else:
                        order = 1.0
                mol.bonds.append(Bond(other, prev, order, aromatic=(order == 1.5)))
                pending_bond = None
            else:
                ring_open[num] = (prev, pending_bond)
                pending_bond = None
        elif c.upper() in _ORGANIC_ONE or s.startswith(_ORGANIC_TWO[0], i) or s.startswith(_ORGANIC_TWO[1], i):
            if s.startswith("Cl", i) or s.startswith("Br", i):
                sym, ln, arom = s[i : i + 2], 2, False
            elif c in _AROMATIC_ORGANIC:
                sym, ln, arom = c.upper(), 1, True
            elif c in _ORGANIC_ONE:
                sym, ln, arom = c, 1, False
            else:
                raise SmilesError(f"unexpected char {c!r} in {s!r} at {i}")
            atom = Atom(symbol=sym, aromatic=arom, smiles_pos=i, smiles_end=i + ln)
            i += ln
            idx = _add_atom(mol, atom, prev, pending_bond)
            prev, pending_bond = idx, None
        elif c == "*":
            atom = Atom(symbol="*", smiles_pos=i, smiles_end=i + 1)
            i += 1
            idx = _add_atom(mol, atom, prev, pending_bond)
            prev, pending_bond = idx, None
        elif c in " \t":
            break  # SMILES may be followed by a title
        else:
            raise SmilesError(f"unexpected char {c!r} in {s!r} at {i}")
    if ring_open:
        raise SmilesError(f"unclosed ring bonds {sorted(ring_open)} in {s!r}")
    if stack:
        raise SmilesError(f"unclosed branches in {s!r}")
    _perceive(mol)
    return mol


def _add_atom(mol: Molecule, atom: Atom, prev: int, pending_bond: Optional[float]) -> int:
    idx = len(mol.atoms)
    mol.atoms.append(atom)
    if prev >= 0:
        order = pending_bond
        if order is None:
            order = 1.5 if (mol.atoms[prev].aromatic and atom.aromatic) else 1.0
        mol.bonds.append(Bond(prev, idx, order, aromatic=(order == 1.5)))
    return idx


def _ring_membership(mol: Molecule) -> None:
    """Mark atoms/bonds that lie on a cycle (DFS back-edge based biconnected test)."""
    n = mol.num_atoms
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for bi, bd in enumerate(mol.bonds):
        adj[bd.a].append((bd.b, bi))
        adj[bd.b].append((bd.a, bi))

    disc = [-1] * n
    low = [0] * n
    timer = [0]

    def dfs(root: int) -> None:
        # iterative Tarjan bridge-finding; non-bridge edges lie on cycles
        stack = [(root, -1, iter(adj[root]))]
        disc[root] = low[root] = timer[0]
        timer[0] += 1
        while stack:
            u, pe, it = stack[-1]
            advanced = False
            for v, bi in it:
                if bi == pe:
                    continue
                if disc[v] == -1:
                    disc[v] = low[v] = timer[0]
                    timer[0] += 1
                    stack.append((v, bi, iter(adj[v])))
                    advanced = True
                    break
                else:
                    low[u] = min(low[u], disc[v])
            if not advanced:
                stack.pop()
                if stack:
                    pu = stack[-1][0]
                    low[pu] = min(low[pu], low[u])
                    if low[u] > disc[pu]:
                        pass  # bridge: (pu,u) not in ring
                    else:
                        mol.bonds[pe].in_ring = True

    for r in range(n):
        if disc[r] == -1:
            dfs(r)
    for bd in mol.bonds:
        if bd.in_ring:
            mol.atoms[bd.a].in_ring = True
            mol.atoms[bd.b].in_ring = True


def _perceive(mol: Molecule) -> None:
    """Fill degree, implicit/total H, radicals, hybridization, ring flags."""
    n = mol.num_atoms
    bond_sum = [0.0] * n
    arom_bonds = [0] * n
    max_order = [0.0] * n
    n_double = [0] * n
    degree = [0] * n
    for bd in mol.bonds:
        for end, other in ((bd.a, bd.b), (bd.b, bd.a)):
            degree[end] += 1
            if bd.order == 1.5:
                arom_bonds[end] += 1
                bond_sum[end] += 1.0
            else:
                bond_sum[end] += bd.order
                if bd.order == 2.0:
                    n_double[end] += 1
            max_order[end] = max(max_order[end], bd.order)

    _ring_membership(mol)

    for i, atom in enumerate(mol.atoms):
        atom.degree = degree[i]
        # explicit valence: aromatic bonds count 1, plus delocalization bump below
        ev = bond_sum[i]
        if atom.aromatic and arom_bonds[i] >= 2:
            ev += 1.0  # one formal double bond in the Kekulé structure
        ev_int = int(round(ev))

        if atom.explicit_h is not None:
            atom.implicit_h = 0
            atom.total_h = atom.explicit_h
            valences = _DEFAULT_VALENCES.get(atom.symbol, ())
            used = ev_int + atom.explicit_h + abs(0)  # charge adjusts below
            target = _charge_adjusted_valences(atom, valences)
            rad = 0
            for t in target:
                if used <= t:
                    rad = t - used
                    break
            # radical electrons only when under-valent w.r.t. the smallest target
            atom.radical_electrons = rad if (target and used < target[0]) else 0
        else:
            valences = _charge_adjusted_valences(atom, _DEFAULT_VALENCES.get(atom.symbol, ()))
            hcount = 0
            for t in valences:
                if ev_int <= t:
                    hcount = t - ev_int
                    break
            atom.implicit_h = max(0, hcount)
            atom.total_h = atom.implicit_h
            atom.radical_electrons = 0

        # hybridization heuristic
        if atom.aromatic:
            atom.hybridization = "SP2"
        elif max_order[i] >= 3.0 or n_double[i] >= 2:
            atom.hybridization = "SP"
        elif n_double[i] == 1:
            atom.hybridization = "SP2"
        elif degree[i] == 0 and atom.total_h == 0:
            atom.hybridization = "S"  # bare ion, e.g. [Na+]
        else:
            atom.hybridization = "SP3"


def _charge_adjusted_valences(atom: Atom, valences: Tuple[int, ...]) -> Tuple[int, ...]:
    """Default valences shifted by formal charge (N+ -> 4, O- -> 1, etc.)."""
    if not valences:
        return ()
    ch = atom.charge
    if ch == 0:
        return valences
    sym = atom.symbol
    if sym in ("N", "P") and ch > 0:
        return tuple(v + ch for v in valences)
    if sym in ("O", "S") and ch > 0:
        return tuple(v + ch for v in valences)
    if ch < 0:
        return tuple(max(0, v + ch) for v in valences)
    if sym in ("C", "B"):
        return tuple(max(0, v - abs(ch)) for v in valences)
    return valences
