"""PMMA — paired multimodal attention encoder (port of ``druglamp_tpu/nn/pmma.py``).

- Embeddings: learned positional embeddings ``pe_prot``/``pe_mol`` added to the
  two streams.  The prot stream has no Linear (the reference discards its
  output); the mol stream's ``mol_embeddings`` Linear is applied.
- Blocks 0–1 (paired): per stream s with the other stream o, the self term
  softmax(Q_s K_sᵀ/√d)V_s and the guided term softmax(Q_o K_sᵀ/√d)V_s are
  concatenated on features → fc(2E→E) → out(E→E); pre-LN and a 4× GELU MLP
  per stream.
- Block 2 concatenates the streams on features (256→512); blocks 2–3 are plain
  4-head self-attention at width 512.
- Final LayerNorm.  Every LayerNorm in PMMA uses eps 1e-6.
- Dropout (train mode only) on the two embeddings and inside each MLP, with
  masks drawn from the ``generator`` passed to ``forward``.

The attention cores go through ``kernels/attention.py``: the hand-written
CUDA kernels on a CUDA tensor, the plain PyTorch version on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from druglamp_tpu_torch.kernels import attention
from druglamp_tpu_torch.nn.layers import Dense, LayerNorm, dropout, gelu


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, E) → contiguous (B, H, L, E/H), the kernels' operand layout."""
    B, L, E = x.shape
    return x.reshape(B, L, num_heads, E // num_heads).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D)


def _ln(width: int) -> LayerNorm:
    return LayerNorm(width, eps=1e-6)


class Mlp(nn.Module):
    """4× GELU MLP: xavier weights, N(0, 1e-6) bias."""

    def __init__(self, hidden_size: int, dropout_rate: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Dense(hidden_size, 4 * hidden_size, dtype=dtype, init="xavier")
        self.fc2 = Dense(4 * hidden_size, hidden_size, dtype=dtype, init="xavier")
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(gelu(self.fc1(x)), self.dropout_rate, self.training, generator)
        return dropout(self.fc2(x), self.dropout_rate, self.training, generator)


class PairedAttention(nn.Module):
    """Two-stream paired attention."""

    def __init__(self, hidden_size: int, num_heads: int = 4, vis: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.vis = vis
        E = hidden_size
        for name in ("query", "key", "value", "query_mol", "key_mol", "value_mol",
                     "out", "out_mol"):
            self.add_module(name, Dense(E, E, dtype=dtype))
        self.fc = Dense(2 * E, E, dtype=dtype)
        self.fc_mol = Dense(2 * E, E, dtype=dtype)

    def forward(self, prot: torch.Tensor, mol: torch.Tensor):
        H = self.num_heads
        q_p = _split_heads(self.query(prot), H)
        k_p = _split_heads(self.key(prot), H)
        v_p = _split_heads(self.value(prot), H)
        q_m = _split_heads(self.query_mol(mol), H)
        k_m = _split_heads(self.key_mol(mol), H)
        v_m = _split_heads(self.value_mol(mol), H)

        # prot stream: self(q_p against prot K/V) + guided(q_m against prot K/V)
        self_p, guided_p, w_p, gw_p = attention.paired_attention_core(
            q_p, k_p, v_p, q_m, need_weights=self.vis)
        attn_prot = torch.cat([_merge_heads(self_p), _merge_heads(guided_p)], dim=-1)
        attn_prot = self.out(self.fc(attn_prot))

        # mol stream: self(q_m against mol K/V) + guided(q_p against mol K/V)
        self_m, guided_m, _, _ = attention.paired_attention_core(q_m, k_m, v_m, q_p)
        attn_mol = torch.cat([_merge_heads(self_m), _merge_heads(guided_m)], dim=-1)
        attn_mol = self.out_mol(self.fc_mol(attn_mol))
        return attn_prot, attn_mol, w_p, gw_p


class SelfAttention(nn.Module):
    """Plain multi-head self-attention."""

    def __init__(self, hidden_size: int, num_heads: int = 4, vis: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.vis = vis
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(hidden_size, hidden_size, dtype=dtype))

    def forward(self, x: torch.Tensor):
        H = self.num_heads
        q = _split_heads(self.query(x), H)
        k = _split_heads(self.key(x), H)
        v = _split_heads(self.value(x), H)
        out, w = attention.self_attention_core(q, k, v, need_weights=self.vis)
        return self.out(_merge_heads(out)), w


class PMMABlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int = 4, mm: bool = False,
                 dropout_rate: float = 0.1, vis: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mm = mm
        E = hidden_size
        self.attention_norm = _ln(E)
        self.ffn_norm = _ln(E)
        self.ffn = Mlp(E, dropout_rate, dtype)
        if mm:
            self.att_norm_mol = _ln(E)
            self.attn = PairedAttention(E, num_heads, vis, dtype)
            self.ffn_norm_mol = _ln(E)
            self.ffn_mol = Mlp(E, dropout_rate, dtype)
        else:
            self.attn = SelfAttention(E, num_heads, vis, dtype)

    def forward(self, prot: torch.Tensor, mol: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if not self.mm:
            x, w = self.attn(self.attention_norm(prot))
            x = x + prot
            return self.ffn(self.ffn_norm(x), generator) + x, None, w, None

        p, m, w, gw = self.attn(self.attention_norm(prot), self.att_norm_mol(mol))
        p, m = p + prot, m + mol
        p = self.ffn(self.ffn_norm(p), generator) + p
        m = self.ffn_mol(self.ffn_norm_mol(m), generator) + m
        return p, m, w, gw


class PairedMultimodalAttention(nn.Module):
    """Embeddings + 4 blocks + final norm.  ``hidden_size`` is the per-stream
    width (2 × n_hidden); the output width is 2 × hidden_size."""

    def __init__(self, hidden_size: int = 256, num_heads: int = 4, num_layers: int = 4,
                 feat_len: int = 256, mol_len: int = 256, dropout_rate: float = 0.1,
                 vis: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        E = hidden_size
        self.num_layers = num_layers
        self.vis = vis
        self.pe_prot = nn.Parameter(torch.zeros(1, feat_len, E))
        self.pe_mol = nn.Parameter(torch.zeros(1, mol_len, E))
        self.mol_embeddings = Dense(E, E, dtype=dtype)
        self.dropout_rate = dropout_rate
        for i in range(num_layers):
            block = (PMMABlock(E, num_heads, True, dropout_rate, vis, dtype) if i < 2
                     else PMMABlock(2 * E, num_heads, False, dropout_rate, vis, dtype))
            self.add_module(f"block_{i}", block)
        self.encoder_norm = _ln(2 * E)

    def forward(self, prot: torch.Tensor, mol: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]], List[Optional[torch.Tensor]]]:
        rate, train = self.dropout_rate, self.training
        mol = dropout(self.mol_embeddings(mol) + self.pe_mol, rate, train, generator)
        x = dropout(prot + self.pe_prot, rate, train, generator)
        weights, guided_weights = [], []
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            if i < 2:
                x, mol, w, gw = block(x, mol, generator)
            else:
                if i == 2:
                    x = torch.cat([x, mol], dim=-1)
                x, _, w, gw = block(x, generator=generator)
            if self.vis:
                weights.append(w)
                guided_weights.append(gw)
        return self.encoder_norm(x), weights, guided_weights

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.pe_prot.zero_()
            self.pe_mol.zero_()
