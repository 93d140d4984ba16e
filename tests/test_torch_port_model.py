"""Whole-forward parity of the port's three model variants with the JAX
package (fp32, tiny configuration, weights carried over by the weight bridge,
eval BatchNorm with random running stats), the score tolerance of
docs/PARITY.md; and the weight bridge's refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from druglamp_tpu.models.registry import build_model as jax_build_model
from druglamp_tpu.utils.synthetic import make_batch
from druglamp_tpu_torch.convert import from_jax_params
from druglamp_tpu_torch.models.registry import build_model as port_build_model
from tests.torch_port_util import (ND, NP, SCORE_ATOL, build_pair, jax_variables, port_config,
                                   tiny_cfg, to_torch)

VARIANTS = ["DrugLAMP", "DrugLAMPwoLLM", "DrugLAMP2C2P"]


@pytest.fixture(scope="module")
def cfg():
    return tiny_cfg()


@pytest.fixture(scope="module")
def batch(cfg):
    return make_batch(cfg, 5, seed=3, n_drug_feature=ND, n_prot_feature=NP)


@pytest.mark.parametrize("name", VARIANTS)
def test_forward_score_and_gca_logits(name, cfg, batch):
    jmodel, params, stats, pmodel = build_pair(name, cfg, seed=VARIANTS.index(name))
    ref = jmodel.apply({"params": params, "batch_stats": stats},
                       jax.tree.map(jnp.asarray, batch), train=False, need_attn=True)
    with torch.no_grad():
        out = pmodel(to_torch(batch), need_attn=True)
    assert out["score"].shape == (5, 1) and out["score"].dtype == torch.float32
    np.testing.assert_allclose(out["score"].numpy(), np.asarray(ref["score"]),
                               rtol=0, atol=SCORE_ATOL)
    for key in ("A_v_gca", "A_x_gca"):
        if ref[key] is None:
            assert out[key] is None
        else:
            np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                       rtol=0, atol=SCORE_ATOL)


def test_bf16_forward_follows_the_reference(batch):
    """The bf16 compute path on the CPU: the two frameworks round at slightly
    different points (a fused bias add, the order of sums), so the scores agree
    to bf16 precision: 1e-3 abs, one bf16 ulp at the scores' magnitude (~0.16)."""
    cfg16 = tiny_cfg("bfloat16")
    jmodel, params, stats, pmodel = build_pair("DrugLAMP", cfg16, seed=4)
    ref = jmodel.apply({"params": params, "batch_stats": stats},
                       jax.tree.map(jnp.asarray, batch), train=False)["score"]
    with torch.no_grad():
        out = pmodel(to_torch(batch))["score"]
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def trees(cfg):
    jmodel = jax_build_model("DrugLAMPwoLLM", cfg, ND, NP)
    return jax_variables(jmodel, cfg)


def _fresh(cfg):
    return port_build_model("DrugLAMPwoLLM", port_config(cfg), ND, NP)


def test_bridge_lists_skipped_heads(cfg, trees):
    """The bridge skips nothing now: the SSL and CM heads' leaves (here
    DrugLAMPwoLLM's MLM head and the CM head, BatchNorm stats included) map
    to the model's keys like every other leaf."""
    params, stats = trees
    state = from_jax_params(params, stats, _fresh(cfg))
    heads = {k for k in state if k.split(".")[0] in ("ssl_model", "cm_model")}
    assert any(k.startswith("ssl_model.to_logits.") for k in heads)
    assert {"cm_model.prot2latent.bn.running_mean", "cm_model.prot2latent.bn.weight"} <= heads
    flax = [p for tree in (params, stats) for p in tree if p in ("ssl_model", "cm_model")]
    assert sorted(flax) == ["cm_model", "cm_model", "ssl_model"]


def test_bridge_refuses_missing_key(cfg, trees):
    params, stats = trees
    params = jax.tree.map(lambda a: a, params)
    del params["v_gca"]["out_proj"]["bias"]
    with pytest.raises(KeyError, match="v_gca.out_proj.bias"):
        from_jax_params(params, stats, _fresh(cfg))


def test_bridge_refuses_leftover_key(cfg, trees):
    params, stats = trees
    params = {**params, "lin_extra": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="lin_extra"):
        from_jax_params(params, stats, _fresh(cfg))


def test_bridge_refuses_shape_mismatch(cfg, trees):
    params, stats = trees
    params = jax.tree.map(lambda a: a, params)
    params["pmma"]["pe_prot"] = np.zeros((1, 3, 3), np.float32)
    with pytest.raises(ValueError, match="pe_prot"):
        from_jax_params(params, stats, _fresh(cfg))


def test_bridge_refuses_missing_batch_stats(cfg, trees):
    params, _ = trees
    with pytest.raises(KeyError, match="running_mean"):
        from_jax_params(params, {}, _fresh(cfg))
