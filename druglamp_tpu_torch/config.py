"""Typed configuration tree (the port's copy of the serving-path dataclasses of
``druglamp_tpu/config.py``).

The defaults are the full model width: ``n_hidden=128``, 512-node graphs, a
9×256 tiled protein, PMMA hidden 256 with 4 heads, bf16 compute.
``Config.to_dict`` / ``config_from_dict`` round-trip a config through a
checkpoint (plain dicts, tuples and scalars, so ``torch.load`` with
``weights_only=True`` reads it).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class DrugConfig:
    node_in_feats: int = 75      # 74 canonical atom features + 1 virtual-node bit
    max_nodes: int = 512
    padding: bool = True


@dataclass(frozen=True)
class ProteinConfig:
    kernel_size: Tuple[int, int, int] = (3, 6, 9)
    padding: bool = True
    seq_len: int = 9 * 256       # tiled integer-coded buffer length
    site_len: int = 9            # number of tiles pooled after the CNN
    max_resis: int = 1022        # truncation before tiling


@dataclass(frozen=True)
class DecoderConfig:
    name: str = "MLP"
    in_dim: int = 256
    hidden_dim: int = 512
    out_dim: int = 128
    binary: int = 1


@dataclass(frozen=True)
class SolverConfig:
    max_epoch: int = 100
    batch_size: int = 16
    num_workers: int = 4
    lr: float = 1e-4
    ssl_lr: float = 3e-5
    cm_lr: float = 1e-5
    seed: int = 42
    eval_batch_size: int = 64
    compute_dtype: str = "bfloat16"   # matmul/attention compute dtype
    grad_mode: str = "per_loss"
    ckpt_every: int = 5
    scan_chunk: int = 64
    bn_mode: str = "global"


@dataclass(frozen=True)
class PMMAConfig:
    """PMMA transformer config; ``hidden_size`` is 2 × n_hidden."""
    hidden_size: int = 256
    num_heads: int = 4
    num_layers: int = 4
    attention_dropout_rate: float = 0.0
    dropout_rate: float = 0.1
    mol_len: int = 256
    feat_len: int = 256
    mlha_dropout: float = 0.0

    @staticmethod
    def for_hidden(n_hidden: int, seq_len: int = 256) -> "PMMAConfig":
        return PMMAConfig(hidden_size=2 * n_hidden, mol_len=seq_len, feat_len=seq_len)


@dataclass(frozen=True)
class Config:
    drug: DrugConfig = field(default_factory=DrugConfig)
    protein: ProteinConfig = field(default_factory=ProteinConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    n_hidden: int = 128
    pmma_dropout: float = 0.1

    @property
    def pmma(self) -> PMMAConfig:
        # feat_len/mol_len = the site-pooled sequence length (256 by default)
        base = PMMAConfig.for_hidden(self.n_hidden,
                                     self.protein.seq_len // self.protein.site_len)
        return dataclasses.replace(base, dropout_rate=self.pmma_dropout)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_SECTIONS = {"drug": DrugConfig, "protein": ProteinConfig,
             "decoder": DecoderConfig, "solver": SolverConfig}


def config_from_dict(tree: Dict[str, Any]) -> Config:
    """Inverse of ``Config.to_dict``; raises on an unknown section or key."""
    kwargs: Dict[str, Any] = {}
    for key, value in tree.items():
        if key in _SECTIONS:
            sub = dict(value)
            if key == "protein" and "kernel_size" in sub:
                sub["kernel_size"] = tuple(sub["kernel_size"])
            kwargs[key] = _SECTIONS[key](**sub)
        elif key in ("n_hidden", "pmma_dropout"):
            kwargs[key] = value
        else:
            raise KeyError(f"unknown config key {key!r}")
    return Config(**kwargs)
