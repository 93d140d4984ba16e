"""Frozen-embedding generation, the reference's ``process()`` path (port of
``druglamp_tpu/encoders/embed_pipeline.py``).

Every protein of an entity table is embedded by ESM-2 (final-layer
representations, BOS/EOS rows included) and every drug by ChemBERTa
(``last_hidden_state``), into the per-entity ``.npy`` files of
``data/cache.py::EmbeddingCache`` (reference handler/dataset.py:124-171):

- the encoders are built on ``device`` (``cuda`` unless the caller asks for
  ``cpu``) and run under ``torch.inference_mode()`` and, at f32, in true f32
  (``utils/numerics.py::true_f32``), so a card's caches agree with the CPU's;
  they are freed before the function returns;
- sequences are grouped by length into the JAX package's padded buckets
  (``_BUCKETS``, ``_DRUG_BUCKETS``); an encoder row depends only on its own
  tokens, so the buckets change no value, and the padded rows and columns
  are sliced off before writing.

Weights: ``esm_ckpt`` / ``chemberta_ckpt`` (a local file read by
``load_torch_state_dict``, renamed by ``encoders/convert.py``), or state
dicts in the port's naming (``esm_params`` / ``chemberta_params``).  With
neither, an encoder takes seeded random weights (``encoders/layers.py::
seeded_state``), with a loud warning: such caches carry no pretrained signal,
and they differ from the JAX package's random-init caches (another RNG).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from druglamp_tpu_torch.chem.hf_tokenizer import HFTokenizer, check_vocab_alignment
from druglamp_tpu_torch.chem.tokenizer import SmilesTokenizer
from druglamp_tpu_torch.data.cache import EmbeddingCache
from druglamp_tpu_torch.encoders.chemberta import ChemBERTa, ChemBERTaConfig
from druglamp_tpu_torch.encoders.convert import chemberta_state_from_torch, esm2_state_from_torch
from druglamp_tpu_torch.encoders.esm2 import ESM2, ESM_PAD, esm2_config_for_layers, esm_tokenize
from druglamp_tpu_torch.encoders.layers import seeded_state
from druglamp_tpu_torch.serve import resolve_device
from druglamp_tpu_torch.utils.numerics import true_f32

# The JAX package's length buckets, kept as they are (on the TPU one bucket
# bounds the compile count; here no value depends on them).
_BUCKETS = (1032,)        # ESM stage: 1022 residues + BOS/EOS
_DRUG_BUCKETS = (520,)    # ChemBERTa stage: 512 tokens incl. CLS/SEP
CHEMBERTA_DENSE_STD = 1.0   # random init: N(0, 1/fan_in), flax's lecun-normal scale


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a local encoder checkpoint file into a flat {name: tensor} dict.

    Accepts .safetensors or a torch-pickled .pt/.pth/.bin (a bare state
    dict, an HF/lightning save with 'state_dict', a fair-esm download with
    'model', or a pickled module — reference handler/dataset.py:54-63 loads
    these same artifacts through esm.pretrained/transformers)."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"{path}: reading a .safetensors checkpoint needs the "
                              "`safetensors` package, which is not installed here; save it "
                              "with torch.save as .pt instead") from e
        return dict(load_file(path))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]                      # fair-esm layout
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]                 # lightning/HF layout
    if not isinstance(obj, dict):
        obj = obj.state_dict()                  # a pickled nn.Module
    return obj


def _bucket(n: int, buckets: Optional[Tuple[int, ...]] = None) -> int:
    for b in (_BUCKETS if buckets is None else buckets):
        if n <= b:
            return b
    return n


def _batched(items: List[Tuple[int, np.ndarray]], batch: int, pad_id: int,
             buckets: Optional[Tuple[int, ...]] = None):
    """Group (ordinal, ids) by length bucket, yield padded (ords, tokens, lens).

    The batch dimension is always padded to ``batch``: tail rows replicate
    row 0 and are excluded from ``ords``/``lens``.  Encoder rows are
    batch-independent (LayerNorm only), so duplicate rows cannot perturb
    real outputs.

    ``pad_id`` must be the model's pad id: ChemBERTa derives RoBERTa position
    ids by counting non-pad tokens, so padding with any other id makes pad
    positions count as real tokens, past ``max_positions`` the embedding
    lookup gives NaN, and the whole output is poisoned."""
    by_bucket: Dict[int, List[Tuple[int, np.ndarray]]] = {}
    for ordn, ids in items:
        by_bucket.setdefault(_bucket(len(ids), buckets), []).append((ordn, ids))
    for b, group in sorted(by_bucket.items()):
        for s in range(0, len(group), batch):
            chunk = group[s : s + batch]
            toks = np.full((batch, b), pad_id, np.int32)
            lens = []
            for r, (_, ids) in enumerate(chunk):
                toks[r, : len(ids)] = ids
                lens.append(len(ids))
            for r in range(len(chunk), batch):      # replicate, don't pad-id
                toks[r] = toks[0]
            yield [o for o, _ in chunk], toks, lens


def _encode(model: torch.nn.Module, todo, batch: int, pad_id: int, buckets, dev, put,
            what: str, verbose: bool, every: int) -> None:
    """Run ``model`` over the padded batches of ``todo`` and ``put`` each real
    row's first ``len`` positions; refuses (raises) a non-finite batch before
    writing any of it."""
    n_done = 0
    with torch.inference_mode():
        for ords, toks, lens in _batched(todo, batch, pad_id, buckets):
            with true_f32():
                reps = model(torch.from_numpy(toks).to(dev))
            reps = reps.float().cpu().numpy()
            if not np.isfinite(reps).all():
                raise RuntimeError(f"non-finite {what} embeddings for ordinals {ords} — "
                                   "refusing to write a poisoned cache")
            for r, (ordn, ln) in enumerate(zip(ords, lens)):
                put(ordn, reps[r, :ln])
            n_done += len(ords)
            if verbose and n_done % every == 0:
                print(f"[embed] {what} {n_done}/{len(todo)}", file=sys.stderr)


def generate_embeddings(table, cache: EmbeddingCache, n_layer: int = 30,
                        esm_params=None, chemberta_params=None,
                        chemberta_cfg: Optional[ChemBERTaConfig] = None,
                        tokenizer=None, batch: int = 8, max_prot_resis: int = 1022,
                        max_drug_tokens: int = 512, seed: int = 0,
                        dtype: torch.dtype = torch.float32,
                        esm_ckpt: Optional[str] = None,
                        chemberta_ckpt: Optional[str] = None,
                        chemberta_tokenizer: Optional[str] = None,
                        verbose: bool = True, device="cuda") -> None:
    """Populate ``cache`` with every missing entity embedding in ``table``.

    ``esm_ckpt`` / ``chemberta_ckpt``: local checkpoint files (.pt /
    .safetensors, HF or fair-esm naming).  ``esm_params`` /
    ``chemberta_params``: state dicts already in the port's naming (they take
    precedence over the files).

    ``chemberta_tokenizer``: directory with the checkpoint's HF tokenizer
    files (vocab.json + merges.txt or tokenizer.json).  Required with real
    ChemBERTa weights, from a file or pre-loaded: token ids must index that
    checkpoint's embedding rows (reference handler/dataset.py:154-160), and
    the regex tokenizer's self-assigned ids would give garbage caches, so
    real weights without their tokenizer raise."""
    dev = resolve_device(device)

    # --- proteins (ESM-2) ---------------------------------------------------
    esm_cfg = esm2_config_for_layers(n_layer)
    with torch.device(dev):
        esm = ESM2(esm_cfg, dtype=dtype)
    if esm_params is None and esm_ckpt:
        if verbose:
            print(f"[embed] loading ESM-2 weights from {esm_ckpt}", file=sys.stderr)
        esm_params = esm2_state_from_torch(load_torch_state_dict(esm_ckpt),
                                           num_layers=esm_cfg.num_layers)
    if esm_params is None:
        if verbose:
            print("[embed] WARNING: no ESM-2 checkpoint given; using "
                  "random-initialized encoder weights", file=sys.stderr)
        esm_params = seeded_state(esm, seed)
    esm.load_state_dict(esm_params)
    todo = [(ordn, esm_tokenize(seq, max_prot_resis))
            for seq, ordn in table.prot2ord.items() if not cache.has_prot(ordn)]
    _encode(esm.eval(), todo, batch, ESM_PAD, None, dev, cache.put_prot, "ESM", verbose, 64)
    del esm, esm_params

    # --- drugs (ChemBERTa) --------------------------------------------------
    cb_cfg = chemberta_cfg or ChemBERTaConfig(hidden=cache.n_drug_feature)
    # real (not random-init) weights arrive as a file or as pre-loaded
    # parameters; both must pass the tokenizer alignment guard
    cb_params_provided = chemberta_params is not None or bool(chemberta_ckpt)
    if tokenizer is None:
        if chemberta_tokenizer:
            tokenizer = HFTokenizer(chemberta_tokenizer)
        else:
            tokenizer = SmilesTokenizer()
            tokenizer.extend_from_corpus(table.drug2ord.keys())
    if tokenizer.vocab_size > cb_cfg.vocab:
        cb_cfg = dataclasses.replace(cb_cfg, vocab=tokenizer.vocab_size)
    if isinstance(tokenizer, HFTokenizer) and tokenizer.pad_id != cb_cfg.pad_id:
        # a checkpoint's tokenizer defines the model's pad id (RoBERTa: 1),
        # from which the model derives its position ids; the regex tokenizer
        # keeps cb_cfg's (its random-init caches are keyed on that choice)
        cb_cfg = dataclasses.replace(cb_cfg, pad_id=tokenizer.pad_id)
    with torch.device(dev):
        cb = ChemBERTa(cb_cfg, dtype=dtype)
    if chemberta_params is None and chemberta_ckpt:
        if verbose:
            print(f"[embed] loading ChemBERTa weights from {chemberta_ckpt}", file=sys.stderr)
        chemberta_params = chemberta_state_from_torch(load_torch_state_dict(chemberta_ckpt),
                                                      num_layers=cb_cfg.num_layers)
    if chemberta_params is None:
        if verbose:
            print("[embed] WARNING: no ChemBERTa checkpoint given; using "
                  "random-initialized encoder weights", file=sys.stderr)
        chemberta_params = seeded_state(cb, seed + 1, dense_std=CHEMBERTA_DENSE_STD)
    if cb_params_provided:
        check_vocab_alignment(tokenizer, chemberta_params)
    cb.load_state_dict(chemberta_params)
    todo_d = [(ordn, np.asarray(tokenizer.encode(smi, max_length=max_drug_tokens), np.int32))
              for smi, ordn in table.drug2ord.items() if not cache.has_drug(ordn)]
    # pad with the model's pad id (see _batched)
    _encode(cb.eval(), todo_d, batch, cb_cfg.pad_id, _DRUG_BUCKETS, dev, cache.put_drug,
            "ChemBERTa", verbose, 256)
    del cb, chemberta_params
    if dev.type == "cuda":
        torch.cuda.empty_cache()        # the encoders' blocks go back before training
