"""ESM-2 protein language model (port of ``druglamp_tpu/encoders/esm2.py``).

The frozen protein encoder the reference runs through fair-esm
(handler/dataset.py:54-63,138-147).  Token embedding → N pre-LN transformer
blocks with rotary position embeddings on Q/K → final LayerNorm; the output
is fair-esm's ``representations[num_layers]`` (after the final LayerNorm).
The MLM and contact heads are not needed for the caches and are omitted.

Module and parameter names are fair-esm's (``embed_tokens``,
``layers.{i}.self_attn.q_proj``, ``emb_layer_norm_after``, ...), so a fair-esm
state dict loads as it is; ``encoders/convert.py`` renames HF ``EsmModel``
checkpoints and ``druglamp_tpu_torch/convert.py`` the JAX package's flax
trees.  Numerics follow the JAX module: rotary over the whole head dim with
cos/sin in f32 from positions ``arange(L)`` (pads included), attention
logits and probabilities in f32 (``matmul_f32``), pad logits at
``finfo(f32).min``, exact GELU, LayerNorm in f32 with eps 1e-5, and the
residual stream in f32 at any compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from druglamp_tpu_torch.encoders.layers import attention_core, take
from druglamp_tpu_torch.nn.layers import Dense, LayerNorm, gelu

# fair-esm alphabet (standard ordering; prepend <cls>, append <eos>)
ESM_ALPHABET = [
    "<cls>", "<pad>", "<eos>", "<unk>", "L", "A", "G", "V", "S", "E", "R", "T",
    "I", "D", "P", "K", "Q", "N", "F", "Y", "M", "H", "W", "C", "X", "B", "U",
    "Z", "O", ".", "-", "<null_1>", "<mask>",
]
ESM_TOK2IDX = {t: i for i, t in enumerate(ESM_ALPHABET)}
ESM_CLS, ESM_PAD, ESM_EOS, ESM_UNK, ESM_MASK = 0, 1, 2, 3, 32


def esm_tokenize(seq: str, max_len: Optional[int] = None) -> np.ndarray:
    """<cls> + residues + <eos> (reference truncates to 1022 residues first)."""
    if max_len is not None:
        seq = seq[:max_len]
    ids = [ESM_CLS] + [ESM_TOK2IDX.get(c.upper(), ESM_UNK) for c in seq] + [ESM_EOS]
    return np.array(ids, dtype=np.int32)


@dataclass(frozen=True)
class ESM2Config:
    num_layers: int = 30
    embed_dim: int = 640
    num_heads: int = 20
    vocab: int = 33
    ffn_dim: Optional[int] = None
    layer_norm_eps: float = 1e-5   # fair-esm / HF esm2 checkpoints use 1e-5

    @property
    def ffn(self) -> int:
        return self.ffn_dim or 4 * self.embed_dim


_ESM2_SIZES = {
    12: ESM2Config(12, 480, 20),
    30: ESM2Config(30, 640, 20),
    33: ESM2Config(33, 1280, 20),
    36: ESM2Config(36, 2560, 40),
    48: ESM2Config(48, 5120, 40),
}


def esm2_config_for_layers(n_layer: int) -> ESM2Config:
    return _ESM2_SIZES[n_layer]


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor):
    """ESM-2 rotary embeddings over the full head dim (theta 10000); cos and
    sin in f32, the results cast back to q's and k's dtypes."""
    dim = q.shape[-1]
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=q.device) / dim))
    freqs = positions[:, None].float() * inv_freq[None, :]          # (L, dim/2)
    emb = torch.cat([freqs, freqs], dim=-1)                          # (L, dim)
    cos, sin = emb.cos()[None, None], emb.sin()[None, None]
    q2 = q * cos + _rotate_half(q) * sin
    k2 = k * cos + _rotate_half(k) * sin
    return q2.to(q.dtype), k2.to(k.dtype)


class ESMSelfAttention(nn.Module):
    def __init__(self, cfg: ESM2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        E = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.dtype = dtype
        self.q_proj = Dense(E, E, dtype=dtype)
        self.k_proj = Dense(E, E, dtype=dtype)
        self.v_proj = Dense(E, E, dtype=dtype)
        self.out_proj = Dense(E, E, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        B, L, E = x.shape
        H = self.num_heads

        def split(t):
            return t.reshape(B, L, H, E // H).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        q, k = apply_rotary(q, k, torch.arange(L, device=x.device))
        out = attention_core(q, k, v, pad_mask, self.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, E))


class ESMLayer(nn.Module):
    def __init__(self, cfg: ESM2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        E, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.self_attn_layer_norm = LayerNorm(E, eps=eps)
        self.self_attn = ESMSelfAttention(cfg, dtype)
        self.final_layer_norm = LayerNorm(E, eps=eps)
        self.fc1 = Dense(E, cfg.ffn, dtype=dtype)
        self.fc2 = Dense(cfg.ffn, E, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), pad_mask)
        return x + self.fc2(gelu(self.fc1(self.final_layer_norm(x))))


class ESM2(nn.Module):
    def __init__(self, cfg: ESM2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(cfg.vocab, cfg.embed_dim)
        self.layers = nn.ModuleList(ESMLayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.emb_layer_norm_after = LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) int → final-layer representations (B, L, E), f32.

        Padding (<pad>=1) is masked out of attention; padded outputs are
        whatever the stack produces there and are sliced off by callers."""
        pad_mask = tokens == ESM_PAD
        x = take(self.embed_tokens.weight.to(self.dtype), tokens)
        x = x.masked_fill(pad_mask[..., None], 0.0)
        # ESM-2 token-dropout inference rescale: <mask> embeddings are zeroed
        # and the rest scaled by (1 − 0.12) / (1 − observed mask ratio), in f32
        # (0.88 when no <mask> token is present, the cache-generation case)
        mask_tok = tokens == ESM_MASK
        x = x.masked_fill(mask_tok[..., None], 0.0)
        src_len = (~pad_mask).sum(dim=-1).clamp(min=1)
        mask_ratio_obs = mask_tok.sum(dim=-1).float() / src_len
        x = x * ((1.0 - 0.12) / (1.0 - mask_ratio_obs))[:, None, None]
        for layer in self.layers:
            x = layer(x, pad_mask)
        return self.emb_layer_norm_after(x)

