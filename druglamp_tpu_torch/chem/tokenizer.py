"""SMILES tokenization for the drug language-model stream.

The reference uses the HF ChemBERTa-77M-MTR BPE tokenizer and remaps
atom-graph edges onto token indices via character-span matching
(reference utils.py:119-183 ``smiles_edges_to_token_edges`` /
``get_indexmap``).  This module provides:

- :class:`SmilesTokenizer`: the standard molecular regex tokenizer with a
  fixed base vocabulary (CLS/PAD/SEP/UNK/MASK + atoms/bonds/digits), and the
  ability to extend the vocab from a corpus.  When HF ChemBERTa tokenizer
  files are available on disk they can be used instead (chem/hf_tokenizer.py)
  — this tokenizer keeps the framework fully self-contained.
- :func:`smiles_token_edges`: exact atom→token mapping using the parser's
  recorded character spans (strictly stronger than the reference's
  ``str.find`` heuristic), producing the same "node token" edge semantics:
  only edges between distinct node tokens survive, deduplicated.

This is the PyTorch port's own copy of ``druglamp_tpu/chem/tokenizer.py``
(the port imports nothing of the JAX package); the tests hold the two to
bit-identical ids, spans and edges.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from druglamp_tpu_torch.chem.smiles import Molecule, parse_smiles

__all__ = ["SmilesTokenizer", "smiles_token_edges", "SMILES_TOKEN_RE"]

# The canonical molecular-transformer regex (public domain pattern used across
# the mol-ML literature).
SMILES_TOKEN_RE = re.compile(
    r"(\[[^\]]+\]|Br|Cl|Si|Se|se|@@|@|%\d{2}|[BCNOPSFIbcnops]|[a-zA-Z]"
    r"|\d|\(|\)|\.|=|#|-|\+|\\|/|:|~|\*|\$)"
)

_SPECIALS = ["<pad>", "<cls>", "<sep>", "<unk>", "<mask>"]
_BASE_TOKENS = (
    ["C", "N", "O", "S", "F", "Cl", "Br", "I", "P", "B", "Si", "Se",
     "c", "n", "o", "s", "p", "b", "se"]
    + [str(d) for d in range(10)]
    + ["(", ")", "=", "#", "-", "+", "/", "\\", ".", ":", "@", "@@", "*", "%10", "%11", "%12"]
)


class SmilesTokenizer:
    """Regex SMILES tokenizer with CLS/SEP wrapping, HF-encode-like output."""

    def __init__(self, extra_tokens: Optional[Sequence[str]] = None):
        self.vocab: Dict[str, int] = {}
        for tok in _SPECIALS + _BASE_TOKENS:
            self.vocab.setdefault(tok, len(self.vocab))
        for tok in extra_tokens or ():
            self.vocab.setdefault(tok, len(self.vocab))
        self.pad_id = self.vocab["<pad>"]
        self.cls_id = self.vocab["<cls>"]
        self.sep_id = self.vocab["<sep>"]
        self.unk_id = self.vocab["<unk>"]
        self.mask_id = self.vocab["<mask>"]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def extend_from_corpus(self, smiles_iter) -> None:
        """Add every unseen surface token from a corpus (e.g. bracket atoms)."""
        for smi in smiles_iter:
            for tok in self.tokenize(smi):
                self.vocab.setdefault(tok, len(self.vocab))

    def tokenize(self, smiles: str) -> List[str]:
        return SMILES_TOKEN_RE.findall(smiles)

    def tokenize_with_spans(self, smiles: str) -> List[Tuple[str, int, int]]:
        out = []
        for m in SMILES_TOKEN_RE.finditer(smiles):
            out.append((m.group(0), m.start(), m.end()))
        return out

    def encode(self, smiles: str, max_length: Optional[int] = None) -> List[int]:
        """CLS + tokens + SEP, truncated to max_length like HF ``encode``."""
        ids = [self.cls_id]
        ids += [self.vocab.get(t, self.unk_id) for t in self.tokenize(smiles)]
        ids.append(self.sep_id)
        if max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_id]
        return ids


def smiles_token_edges(
    smiles: str,
    tokenizer: Optional[SmilesTokenizer] = None,
    mol: Optional[Molecule] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Map molecular bonds to token-graph edges.

    Returns (edges, node_token_mask):
      edges: (2, E) int32 — undirected bond list expressed in *node-token*
        ordinals (the k-th alphabetic/atom token is node k), self-edges
        removed, duplicates removed — semantics of reference utils.py:137-150.
      node_token_mask: (T,) bool over the tokenizer's surface tokens (no
        CLS/SEP) marking which tokens are atom tokens (reference
        index_map['keep']).
    """
    tokenizer = tokenizer or SmilesTokenizer()
    if mol is None:
        mol = parse_smiles(smiles)
    spans = tokenizer.tokenize_with_spans(smiles)

    # token ordinal among "node tokens" for each surface token
    node_tok_of_surface: List[int] = []
    is_node: List[bool] = []
    k = 0
    for tok, _s, _e in spans:
        alpha = tok.strip("[]").isalpha() if tok.startswith("[") else tok.isalpha()
        is_node.append(alpha)
        node_tok_of_surface.append(k if alpha else -1)
        if alpha:
            k += 1

    # atom index -> surface token index via char position
    tok_of_char: Dict[int, int] = {}
    for ti, (_tok, s, e) in enumerate(spans):
        for c in range(s, e):
            tok_of_char[c] = ti

    atom_node_tok: List[int] = []
    for atom in mol.atoms:
        ti = tok_of_char.get(atom.smiles_pos, -1)
        atom_node_tok.append(node_tok_of_surface[ti] if ti >= 0 else -1)

    seen = set()
    src, dst = [], []
    for bd in mol.bonds:
        u, v = atom_node_tok[bd.a], atom_node_tok[bd.b]
        if u < 0 or v < 0 or u == v:
            continue
        for a, b in ((u, v), (v, u)):
            if (a, b) not in seen:
                seen.add((a, b))
                src.append(a)
                dst.append(b)
    edges = np.array([src, dst], dtype=np.int32) if src else np.zeros((2, 0), dtype=np.int32)
    order = np.lexsort((edges[1], edges[0])) if edges.shape[1] else np.array([], dtype=int)
    return edges[:, order], np.array(is_node, dtype=bool)
