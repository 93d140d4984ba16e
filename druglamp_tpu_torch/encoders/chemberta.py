"""ChemBERTa (RoBERTa-style) SMILES encoder (port of
``druglamp_tpu/encoders/chemberta.py``).

The frozen drug encoder (DeepChem/ChemBERTa-77M-MTR) the reference runs
through HF transformers (handler/dataset.py:54-57,154-160; it consumes
``last_hidden_state``): word + learned-position embeddings (positions
counted from pad_id + 1 over the non-pad tokens), one learned token-type
vector, embedding LayerNorm, N post-LN transformer blocks.  Defaults match
the 77M-MTR card (hidden 384, 3 layers, 12 heads, intermediate 464, 515
positions).  Names follow the JAX module's (``word_embeddings``,
``layers.{i}.attention.query``, ``layers.{i}.output_norm``, ...);
``encoders/convert.py`` renames HF ``RobertaModel`` checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from druglamp_tpu_torch.encoders.layers import attention_core, take
from druglamp_tpu_torch.nn.layers import Dense, LayerNorm, gelu


@dataclass(frozen=True)
class ChemBERTaConfig:
    vocab: int = 600
    hidden: int = 384
    num_layers: int = 3
    num_heads: int = 12
    intermediate: int = 464
    max_positions: int = 515
    pad_id: int = 1
    layer_norm_eps: float = 1e-12


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: ChemBERTaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        E = cfg.hidden
        self.num_heads = cfg.num_heads
        self.dtype = dtype
        self.query = Dense(E, E, dtype=dtype)
        self.key = Dense(E, E, dtype=dtype)
        self.value = Dense(E, E, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        B, L, E = x.shape
        H = self.num_heads

        def split(t):
            return t.reshape(B, L, H, E // H).transpose(1, 2)

        out = attention_core(split(self.query(x)), split(self.key(x)), split(self.value(x)),
                             pad_mask, self.dtype)
        return out.transpose(1, 2).reshape(B, L, E)


class BertLayer(nn.Module):
    def __init__(self, cfg: ChemBERTaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        E, eps = cfg.hidden, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg, dtype)
        self.attention_output = Dense(E, E, dtype=dtype)
        self.attention_norm = LayerNorm(E, eps=eps)
        self.intermediate = Dense(E, cfg.intermediate, dtype=dtype)
        self.output = Dense(cfg.intermediate, E, dtype=dtype)
        self.output_norm = LayerNorm(E, eps=eps)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        x = self.attention_norm(x + self.attention_output(self.attention(x, pad_mask)))
        return self.output_norm(x + self.output(gelu(self.intermediate(x))))


class ChemBERTa(nn.Module):
    def __init__(self, cfg: ChemBERTaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(cfg.vocab, cfg.hidden)
        self.position_embeddings = nn.Embedding(cfg.max_positions, cfg.hidden)
        self.token_type_embedding = nn.Parameter(torch.zeros(cfg.hidden))
        self.emb_norm = LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(cfg, dtype) for _ in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) int → last_hidden_state (B, L, hidden), f32."""
        pad_mask = tokens == self.cfg.pad_id
        # RoBERTa position ids: pad positions keep pad_id, the others count
        # from pad_id + 1 in order of non-pad appearance
        not_pad = (~pad_mask).int()
        positions = torch.cumsum(not_pad, dim=1) * not_pad + self.cfg.pad_id
        x = (take(self.word_embeddings.weight.to(self.dtype), tokens)
             + take(self.position_embeddings.weight.to(self.dtype), positions)
             + self.token_type_embedding)
        x = self.emb_norm(x)
        for layer in self.layers:
            x = layer(x, pad_mask)
        return x
