"""Torch checkpoint → the port's encoder state dicts (port of
``druglamp_tpu/encoders/convert.py``).

Both sides are torch ``Linear``s, so this is a rename with no transposes:
each key of the port's module has its checkpoint names in a table
(``esm2_names``, ``chemberta_names``), looked up bare or under the prefixes
a wrapped model saves (``esm.``/``model.`` for ESM-2: HF ``EsmModel`` or
``EsmForMaskedLM``, and fair-esm; ``roberta.``/``model.`` for ChemBERTa:
HF ``RobertaModel``).  A name the checkpoint lacks raises, naming what was
looked for; checkpoint keys no table names (heads, rotary buffers) are
ignored.  No network access: callers pass a state dict already on disk.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch

# the port's ESM-2 layer module → HF EsmLayer's (fair-esm's names are the port's)
_ESM_LAYER = (("self_attn.q_proj", "attention.self.query"),
              ("self_attn.k_proj", "attention.self.key"),
              ("self_attn.v_proj", "attention.self.value"),
              ("self_attn.out_proj", "attention.output.dense"),
              ("self_attn_layer_norm", "attention.LayerNorm"),
              ("fc1", "intermediate.dense"),
              ("fc2", "output.dense"),
              ("final_layer_norm", "LayerNorm"))
# the port's ChemBERTa layer module → HF RobertaLayer's
_BERT_LAYER = (("attention.query", "attention.self.query"),
               ("attention.key", "attention.self.key"),
               ("attention.value", "attention.self.value"),
               ("attention_output", "attention.output.dense"),
               ("attention_norm", "attention.output.LayerNorm"),
               ("intermediate", "intermediate.dense"),
               ("output", "output.dense"),
               ("output_norm", "output.LayerNorm"))
TOKEN_TYPE = "token_type_embedding"    # HF keeps a (type_vocab, hidden) table: row 0


def esm2_names(num_layers: int) -> Dict[str, Tuple[str, str]]:
    """The port's ESM-2 state-dict key → (HF ``EsmModel`` name, fair-esm name)."""
    names = {"embed_tokens.weight": ("embeddings.word_embeddings.weight",
                                     "embed_tokens.weight")}
    for p in ("weight", "bias"):
        names[f"emb_layer_norm_after.{p}"] = (f"encoder.emb_layer_norm_after.{p}",
                                              f"emb_layer_norm_after.{p}")
    for i in range(num_layers):
        for port, hf in _ESM_LAYER:
            for p in ("weight", "bias"):
                key = f"layers.{i}.{port}.{p}"
                names[key] = (f"encoder.layer.{i}.{hf}.{p}", key)
    return names


def chemberta_names(num_layers: int) -> Dict[str, Tuple[str]]:
    """The port's ChemBERTa state-dict key → (HF ``RobertaModel`` name,)."""
    names = {"word_embeddings.weight": ("embeddings.word_embeddings.weight",),
             "position_embeddings.weight": ("embeddings.position_embeddings.weight",),
             TOKEN_TYPE: ("embeddings.token_type_embeddings.weight",),
             "emb_norm.weight": ("embeddings.LayerNorm.weight",),
             "emb_norm.bias": ("embeddings.LayerNorm.bias",)}
    for i in range(num_layers):
        for port, hf in _BERT_LAYER:
            for p in ("weight", "bias"):
                names[f"layers.{i}.{port}.{p}"] = (f"encoder.layer.{i}.{hf}.{p}",)
    return names


def _rename(state_dict: Mapping, names: Mapping[str, Sequence[str]],
            prefixes: Sequence[str]) -> Dict[str, torch.Tensor]:
    out = {}
    for key, cands in names.items():
        for c in cands:
            hit = next((p + c for p in ("",) + tuple(prefixes) if p + c in state_dict), None)
            if hit is not None:
                out[key] = state_dict[hit].detach().to("cpu", torch.float32)
                break
        else:
            raise KeyError(f"none of {cands} (bare or under {list(prefixes)}) in the checkpoint "
                           f"(have e.g. {sorted(state_dict)[:5]}...)")
    return out


def esm2_state_from_torch(state_dict: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """HF EsmModel (``esm.``-prefixed or bare) or fair-esm state dict → the
    port's ESM2 state dict (f32, CPU)."""
    return _rename(state_dict, esm2_names(num_layers), ("esm.", "model."))


def chemberta_state_from_torch(state_dict: Mapping, num_layers: int
                               ) -> Dict[str, torch.Tensor]:
    """HF RobertaModel state dict (``roberta.``-prefixed or bare) → the
    port's ChemBERTa state dict (f32, CPU)."""
    out = _rename(state_dict, chemberta_names(num_layers), ("roberta.", "model."))
    out[TOKEN_TYPE] = out[TOKEN_TYPE][0]
    return out
