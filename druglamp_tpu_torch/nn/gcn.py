"""Molecular GCN over padded graphs (port of ``druglamp_tpu/nn/gcn.py``).

    Â = D^(-1/2) · A_eff · D^(-1/2),   A_eff = bonds + 2I(real) + 1I(virtual)

with n = ``rsqrt(max(deg, 1))`` computed once per forward and shared by the
three layers.  The adjacency comes dense ((B, N, N) uint8: Â is built once)
or packed (``{"packed", "real"}`` from ``decode_batch(keep_packed=True)``:
each layer's Â·X runs in ``kernels.gcn.gcn_packed_matmul`` from the bits, and
Â never exists in memory).  Each layer: aggregate Â·X → graph Linear →
ReLU, plus the residual ReLU(Linear(x)), then BatchNorm over the flattened
B·N rows (virtual nodes included, as in the reference).  Products take
operands in the compute dtype and accumulate and return f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from druglamp_tpu_torch.kernels import gcn as gcn_kernel
from druglamp_tpu_torch.nn import inits
from druglamp_tpu_torch.nn.layers import Dense, TorchBatchNorm, matmul_f32


class GCNLayer(nn.Module):
    def __init__(self, in_feats: int, out_feats: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.graph = nn.Linear(in_feats, out_feats)
        self.res_connection = Dense(in_feats, out_feats)
        self.bn = TorchBatchNorm(out_feats)

    def forward(self, x: torch.Tensor, adj_norm) -> torch.Tensor:
        """adj_norm: the dense Â, or ``{"packed", "nrm", "n2r"}``."""
        cd = self.compute_dtype or x.dtype
        if isinstance(adj_norm, dict):
            agg = gcn_kernel.gcn_packed_matmul(adj_norm["packed"], adj_norm["nrm"],
                                               adj_norm["n2r"], x.to(cd))
        else:
            agg = matmul_f32(adj_norm, x, cd)
        h = F.relu(matmul_f32(agg, self.graph.weight.t(), cd) + self.graph.bias)
        h = h + F.relu(self.res_connection(x))
        return self.bn(h).to(x.dtype)

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        inits.xavier_uniform_(self.graph.weight, g)
        with torch.no_grad():
            self.graph.bias.zero_()


class MolecularGCN(nn.Module):
    def __init__(self, in_feats: int = 75, dim_embedding: int = 128,
                 hidden_feats: Sequence[int] = (128, 128, 128), padding: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.padding = padding
        self.compute_dtype = dtype
        self.init_transform = nn.Linear(in_feats, dim_embedding, bias=False)
        self.n_layers = len(hidden_feats)
        width = dim_embedding
        for i, feats in enumerate(hidden_feats):
            self.add_module(f"layer_{i}", GCNLayer(width, feats, dtype))
            width = feats

    def forward(self, node_feats: torch.Tensor, adj, degrees: torch.Tensor) -> torch.Tensor:
        """node_feats (B,N,75) f32, adj (B,N,N) uint8 or, packed, {"packed"
        (B,N,N/8) uint8, "real" (B,N) f32}, degrees (B,N) f32 → (B,N,C)."""
        x = node_feats @ self.init_transform.weight.t()
        n = torch.rsqrt(torch.clamp(degrees, min=1.0))
        if isinstance(adj, dict):
            adj_norm = {"packed": adj["packed"], "nrm": n, "n2r": n * n * adj["real"]}
        else:
            adj_norm = (n[:, :, None] * adj.float()) * n[:, None, :]
            adj_norm = adj_norm.to(self.compute_dtype or x.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, adj_norm)
        return x

    def init_weights(self, g: Optional[torch.Generator]) -> None:
        inits.torch_linear_(self.init_transform.weight, g)
        if self.padding:
            # the reference zeroes the last output unit's weights when padding
            with torch.no_grad():
                self.init_transform.weight[-1].zero_()
