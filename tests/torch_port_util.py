"""Shared helpers for the port's parity tests: one tiny configuration and
seeded weights built in the JAX package, carried into the port through
``druglamp_tpu_torch.convert.from_jax_params``."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from druglamp_tpu.config import SolverConfig
from druglamp_tpu.models.registry import build_model as jax_build_model
from druglamp_tpu.utils.synthetic import make_batch, tiny_config
from druglamp_tpu_torch.config import config_from_dict
from druglamp_tpu_torch.convert import from_jax_params
from druglamp_tpu_torch.models.registry import build_model as port_build_model

# The tiny models gain nothing from intra-op threads, and the suite runs
# several pytest workers beside JAX's own thread pools on the same cores.
torch.set_num_threads(1)

ND, NP = 24, 40       # LLM embedding widths of the tiny models
SCORE_ATOL = 2e-5     # forward-score tolerance of docs/PARITY.md (fp32)


def tiny_cfg(compute_dtype: str = "float32"):
    return tiny_config(n_hidden=16, max_nodes=32, site_seq=16, pmma_dropout=0.0,
                       solver=SolverConfig(compute_dtype=compute_dtype))


def port_config(jax_cfg):
    """The port's Config with the same values as a JAX Config."""
    tree = dataclasses.asdict(jax_cfg)
    return config_from_dict({k: tree[k] for k in
                             ("drug", "protein", "decoder", "solver", "n_hidden", "pmma_dropout")})


def perturb(tree, rng: np.random.RandomState, scale: float = 0.05):
    """Add seeded noise to every leaf, so zero-initialized biases and
    positional embeddings take part in the comparison."""
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.randn(*np.shape(a)).astype(np.float32),
                        tree)


def random_stats(stats, rng: np.random.RandomState):
    """Non-trivial BatchNorm running stats (mean N(0, 0.5²), var U(0.5, 2))."""
    def one(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return (0.5 * rng.randn(*a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, stats)


def jax_variables(model, cfg, seed: int = 0):
    """Seeded flax params (perturbed) and random BN stats, as numpy trees."""
    batch = jax.tree.map(jnp.asarray, make_batch(cfg, 4, n_drug_feature=ND, n_prot_feature=NP))
    # jitted: the eager init of the whole tree (SSL/CM heads included) takes ~1 min
    init = jax.jit(functools.partial(model.init, method="init_all"))
    variables = init({"params": jax.random.key(seed), "dropout": jax.random.key(1)},
                     batch, jax.random.key(2))
    rng = np.random.RandomState(seed)
    return perturb(variables["params"], rng), random_stats(variables["batch_stats"], rng)


def build_pair(name: str, cfg, seed: int = 0):
    """(jax model, params, batch_stats, port model in eval mode on the CPU)."""
    jmodel = jax_build_model(name, cfg, ND, NP)
    params, stats = jax_variables(jmodel, cfg, seed)
    pmodel = port_build_model(name, port_config(cfg), ND, NP)
    state = from_jax_params(params, stats, pmodel)
    pmodel.load_state_dict(state)
    return jmodel, params, stats, pmodel.eval()


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
