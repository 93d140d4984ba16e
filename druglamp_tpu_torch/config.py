"""Typed configuration tree (the port's copy of ``druglamp_tpu/config.py``).

The defaults are the full model width: ``n_hidden=128``, 512-node graphs, a
9×256 tiled protein, PMMA hidden 256 with 4 heads, bf16 compute.
``Config.to_dict`` / ``config_from_dict`` round-trip a config through a
checkpoint (plain dicts, tuples and scalars, so ``torch.load`` with
``weights_only=True`` reads it).  ``load_config`` overlays a reference-schema
YAML file (``configs/DrugLAMP*.yaml``: SOLVER / RS / DECODER / COMET ...
sections) and dotted overrides on the defaults; it imports ``yaml`` when it
reads a file, and nothing else here needs it.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple


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
class RSConfig:
    task: bool = False           # cluster / Tcpi split mode (source_train/target_test)
    method: str = "2C2P"
    ssl: bool = False
    cm: bool = False
    init_epoch: int = 5          # CM starts at this epoch (1-based)
    epoch_step: int = 5          # SSL fires every epoch_step-th epoch
    max_margin: float = 0.5
    reset_epoch: int = 100       # margin-decay reset period (n_re)


@dataclass(frozen=True)
class ResultConfig:
    output_dir: str = field(default_factory=lambda: os.path.join(os.getcwd(), "results"))


@dataclass(frozen=True)
class CometConfig:
    use: bool = False
    workspace: str = ""
    project_name: str = "DrugLAMP"
    tag: str = ""


@dataclass(frozen=True)
class ParallelConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1


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
    rs: RSConfig = field(default_factory=RSConfig)
    result: ResultConfig = field(default_factory=ResultConfig)
    comet: CometConfig = field(default_factory=CometConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
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


_SECTIONS = {"drug": DrugConfig, "protein": ProteinConfig, "decoder": DecoderConfig,
             "solver": SolverConfig, "rs": RSConfig, "result": ResultConfig,
             "comet": CometConfig, "parallel": ParallelConfig}


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


# --- YAML loading (the reference's key schema) ------------------------------------

_SECTION_FIELD_MAP = {
    "DRUG": ("drug", {"NODE_IN_FEATS": "node_in_feats", "MAX_NODES": "max_nodes",
                      "PADDING": "padding"}),
    "PROTEIN": ("protein", {"KERNEL_SIZE": "kernel_size", "PADDING": "padding",
                            "SEQ_LEN": "seq_len", "SITE_LEN": "site_len",
                            "MAX_RESIS": "max_resis"}),
    "DECODER": ("decoder", {"NAME": "name", "IN_DIM": "in_dim", "HIDDEN_DIM": "hidden_dim",
                            "OUT_DIM": "out_dim", "BINARY": "binary"}),
    "SOLVER": ("solver", {"MAX_EPOCH": "max_epoch", "BATCH_SIZE": "batch_size",
                          "NUM_WORKERS": "num_workers", "LR": "lr", "SSL_LR": "ssl_lr",
                          "CM_LR": "cm_lr", "SEED": "seed",
                          "EVAL_BATCH_SIZE": "eval_batch_size",
                          "COMPUTE_DTYPE": "compute_dtype", "GRAD_MODE": "grad_mode"}),
    "RS": ("rs", {"TASK": "task", "METHOD": "method", "SSL": "ssl", "CM": "cm",
                  "INIT_EPOCH": "init_epoch", "EPOCH_STEP": "epoch_step",
                  "MAX_MARGIN": "max_margin", "RESET_EPOCH": "reset_epoch"}),
    "RESULT": ("result", {"OUTPUT_DIR": "output_dir"}),
    "COMET": ("comet", {"USE": "use", "WORKSPACE": "workspace",
                        "PROJECT_NAME": "project_name", "TAG": "tag"}),
    "PARALLEL": ("parallel", {"DATA_AXIS": "data_axis", "MODEL_AXIS": "model_axis",
                              "MODEL_PARALLEL_SIZE": "model_parallel_size"}),
}

# Config's top-level fields (a MODEL section, not in the reference schema)
_TOP_FIELD_MAP = {"N_HIDDEN": "n_hidden", "PMMA_DROPOUT": "pmma_dropout"}


def _coerce(value: Any, target: Any) -> Any:
    """A YAML scalar as the dataclass field's type (yaml reads 1e-4 as str)."""
    if isinstance(target, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(target, int) and not isinstance(target, bool):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        return tuple(value)
    return value


def merge_yaml_dict(cfg: Config, tree: Dict[str, Any]) -> Config:
    """Merge a reference-schema YAML dict (SOLVER/RS/... sections) into a Config."""
    updates: Dict[str, Any] = {}
    for section, payload in (tree or {}).items():
        if section == "MODEL":
            for key, value in (payload or {}).items():
                if key not in _TOP_FIELD_MAP:
                    raise KeyError(f"Unknown config key MODEL.{key}")
                fname = _TOP_FIELD_MAP[key]
                updates[fname] = _coerce(value, getattr(cfg, fname))
            continue
        if section not in _SECTION_FIELD_MAP:
            raise KeyError(f"Unknown config section: {section!r}")
        attr, key_map = _SECTION_FIELD_MAP[section]
        sub = getattr(cfg, attr)
        sub_updates = {}
        for key, value in (payload or {}).items():
            if key not in key_map:
                raise KeyError(f"Unknown config key {section}.{key}")
            fname = key_map[key]
            sub_updates[fname] = _coerce(value, getattr(sub, fname))
        updates[attr] = replace(sub, **sub_updates)
    return replace(cfg, **updates)


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Defaults, then an optional YAML overlay, then flat ``overrides`` with
    dotted lowercase paths, e.g. ``{"solver.seed": 41}``."""
    cfg = Config()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            tree = yaml.safe_load(f)
        cfg = merge_yaml_dict(cfg, tree)
    for dotted, value in (overrides or {}).items():
        section, _, fname = dotted.partition(".")
        sub = getattr(cfg, section)
        if not hasattr(sub, fname):
            raise KeyError(f"Unknown override {dotted}")
        cfg = replace(cfg, **{section: replace(sub, **{fname: _coerce(value,
                                                                      getattr(sub, fname))})})
    return cfg


def builtin_config_path(model_name: str) -> str:
    """Path of the bundled YAML for a model name (DrugLAMP / DrugLAMPwoLLM /
    DrugLAMP2C2P)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "configs", f"{model_name}.yaml")
