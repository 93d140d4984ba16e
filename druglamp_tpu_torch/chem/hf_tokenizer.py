"""HF-tokenizer adapter for real ChemBERTa checkpoints (port of
``druglamp_tpu/chem/hf_tokenizer.py``).

A real checkpoint's embedding rows are indexed by its own HF BPE tokenizer's
ids (reference handler/dataset.py:154-160); the regex tokenizer
(``chem/tokenizer.py``) assigns its own, so with pretrained weights its ids
would pick the wrong rows and the caches would be garbage without any error.
``HFTokenizer`` wraps the checkpoint's tokenizer files (vocab.json +
merges.txt, or tokenizer.json) behind the interface the embedding pipeline
consumes (encode / tokenize_with_spans / vocab_size / pad_id).

``transformers`` is imported when an ``HFTokenizer`` is made, never when this
module is imported, and read with ``local_files_only`` (no network).  Where
the package is absent, making one raises: the regex tokenizer never stands
in for a checkpoint's own.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


class HFTokenizer:
    """SmilesTokenizer-interface wrapper over a local HF tokenizer dir."""

    def __init__(self, path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                f"--chemberta-tokenizer {path!r}: reading a ChemBERTa checkpoint's tokenizer "
                "files needs the `transformers` package, which is not installed here; the "
                "built-in regex tokenizer cannot stand in for it (its ids index no "
                "pretrained embedding table)") from e

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.path = path
        self.pad_id = self._require("pad_token_id")
        self.cls_id = self._require("cls_token_id")
        self.sep_id = self._require("sep_token_id")
        self.mask_id = getattr(self._tok, "mask_token_id", None)

    def _require(self, attr: str) -> int:
        v = getattr(self._tok, attr, None)
        if v is None:
            raise ValueError(
                f"tokenizer at {self.path} has no {attr}; a ChemBERTa "
                "(RoBERTa-style) tokenizer is required")
        return int(v)

    @property
    def vocab_size(self) -> int:
        # len() includes added special tokens; .vocab_size alone may not
        return len(self._tok)

    def extend_from_corpus(self, smiles_iter) -> None:
        """No-op: a pretrained vocabulary is fixed; extending it would
        desynchronize ids from the checkpoint's embedding rows."""

    def tokenize(self, smiles: str) -> List[str]:
        return self._tok.tokenize(smiles)

    def tokenize_with_spans(self, smiles: str) -> List[Tuple[str, int, int]]:
        """Surface tokens with char spans (for SMILES-token↔atom-graph edge
        remapping, reference utils.py:119-183).  Requires a fast tokenizer
        (offsets come from the Rust backend)."""
        enc = self._tok(smiles, return_offsets_mapping=True,
                        add_special_tokens=False)
        toks = self._tok.convert_ids_to_tokens(enc["input_ids"])
        return [(t, int(a), int(b))
                for t, (a, b) in zip(toks, enc["offset_mapping"])]

    def encode(self, smiles: str, max_length: Optional[int] = None) -> List[int]:
        """CLS + tokens + SEP ids, truncated like HF ``encode``."""
        if max_length is not None:
            return self._tok.encode(smiles, truncation=True,
                                    max_length=max_length)
        return self._tok.encode(smiles)


def check_vocab_alignment(tokenizer, chemberta) -> None:
    """Fail loudly when tokenizer ids cannot index the checkpoint's embedding
    rows (``chemberta``: the port's ChemBERTa module or state dict); the
    failure is otherwise silent (caches full of wrong-row embeddings that
    train to garbage)."""
    weight = (chemberta.word_embeddings.weight if hasattr(chemberta, "word_embeddings")
              else chemberta["word_embeddings.weight"])
    rows = weight.shape[0]
    if tokenizer.vocab_size > rows:
        raise ValueError(
            f"tokenizer vocab ({tokenizer.vocab_size}) exceeds the "
            f"checkpoint's embedding rows ({rows}) — the tokenizer does not "
            "belong to this checkpoint; pass the checkpoint's own tokenizer "
            "files via --chemberta-tokenizer")
    if isinstance(tokenizer, HFTokenizer):
        return
    # the regex tokenizer is only valid with random-init weights (its ids
    # are self-assigned); with a real checkpoint the ids would be misaligned
    # even if the sizes happen to fit
    raise ValueError(
        "a real ChemBERTa checkpoint requires its own HF tokenizer files "
        "(--chemberta-tokenizer <dir with vocab.json+merges.txt or "
        "tokenizer.json>); the built-in regex tokenizer's ids do not match "
        "any pretrained embedding table")
