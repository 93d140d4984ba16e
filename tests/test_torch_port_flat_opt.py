"""The port's flat AdamW (``train/state.py::FlatAdamW``, ``DRUGLAMP_FLAT_OPT=1``)
on the CPU, f32, at a tiny configuration.

- Against the JAX package's ``_apply_optimizer_flat``: from the same
  parameters and the same moments (a seeded ``FlatAdamWState`` carried over
  by ``convert.from_jax_flat_opt``), the same seeded gradients, 1 and 20
  steps: parameters and moments within rtol 1e-5 / atol 1e-7 (the moments
  compared back in JAX's raveling, ``convert.to_jax_flat_opt``).
- Against the port's per-leaf AdamWs (torch's AdamW): 20 steps of the same
  gradients, parameters within rtol 1e-5 / atol 1e-7.
- ``DRUGLAMP_FLAT_OPT=1`` makes ``TrainState.create`` build flat optimizers,
  and a train step through them runs and stays finite.
- Checkpoints: ``m``, ``v`` and ``count`` restored by name through a
  ``Trainer``'s save and ``restore``, and a resumed run continues bit for bit;
  a flat state loaded into per-leaf optimizers, or the reverse, or a state of
  another size, raises.
- ``MeshContext.shard_state`` of a flat state on a 1 × 2 grid (two gloo
  ranks), between two full-gate steps, held to two one-process steps as the
  per-leaf case in ``tests/test_torch_port_tensor_parallel.py`` is: the
  moments gathered within the gradient tolerance, the gathered parameters
  the AdamW update of those moments (1e-6), replicated leaves identical on
  both ranks.
"""

import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from druglamp_tpu.train.state import FlatAdamWState as JFlat
from druglamp_tpu.train.state import _apply_optimizer_flat as jax_flat_step
from druglamp_tpu_torch.config import SolverConfig
from druglamp_tpu_torch.convert import (_flatten, _map_leaf, from_jax_flat_opt, to_jax_flat_opt,
                                        to_jax_paths)
from druglamp_tpu_torch.data.encoding import compact_batch
from druglamp_tpu_torch.data.loader import build_cm_arrays
from druglamp_tpu_torch.models.registry import build_model
from druglamp_tpu_torch.parallel.mesh import tp_plan
from druglamp_tpu_torch.train import steps
from druglamp_tpu_torch.train.state import (B1, B2, EPS, WEIGHT_DECAY, FlatAdamW, TrainState,
                                            apply_optimizer)
from druglamp_tpu_torch.train.trainer import Trainer
from druglamp_tpu_torch.utils import synthetic
from tests.torch_port_ranks import run_ranks
from tests.torch_port_util import ND, NP

RANKS = [sys.executable, "-m", "tests.torch_port_ranks"]
# the recipe's cls LR (Config().solver.lr).  torch's AdamW decays the weights
# before its Adam step, the flat one (as JAX's) in one update: at 1e-3 the
# two orders drift 1.1e-7 apart over 20 steps on an entry near 0
LR = 1e-4
RTOL, ATOL = 1e-5, 1e-7
LRS = (1e-3, 3e-4, 3e-4, 0.5, 1e-3)


def _cfg(dropout=0.0):
    return synthetic.tiny_config(n_hidden=16, max_nodes=32, site_seq=16, pmma_dropout=dropout,
                                 solver=SolverConfig(compute_dtype="float32"))


def _model(name="DrugLAMPwoLLM", seed=0):
    return build_model(name, _cfg(), ND, NP, generator=torch.Generator().manual_seed(seed))


def _params_tree(model):
    """The model's parameters as the JAX package's flax params tree."""
    flat = to_jax_paths(dict(model.named_parameters()), model)
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def _grad_trees(params, n, seed=1):
    """n seeded gradient trees shaped as ``params`` (a few exact zeros in each)."""
    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        def one(p):
            g = (0.1 * np.asarray(p) + 0.02 * (i + 1) * r.randn(*np.shape(p))).astype(np.float32)
            g[r.rand(*np.shape(p)) < 0.05] = 0.0
            return jnp.asarray(g)
        out.append(jax.tree.map(one, params))
    return out


def _set_grads(model, tree):
    """A flax gradient tree into the parameters' ``.grad`` (torch layout)."""
    named = dict(model.named_parameters())
    for path, value in _flatten(tree).items():
        name, value = _map_leaf(path, value)
        named[name].grad = torch.from_numpy(np.array(value))


def _seeded_flat_state(params, seed=2):
    n = sum(int(np.prod(np.shape(p))) for p in jax.tree.leaves(params))
    r = np.random.RandomState(seed)
    return JFlat(m=jnp.asarray(0.01 * r.randn(n), jnp.float32),
                 v=jnp.asarray(1e-4 * r.rand(n), jnp.float32),
                 count=jnp.asarray(3, jnp.int32))


@pytest.mark.parametrize("n_steps", [1, 20])
def test_flat_adamw_matches_the_jax_flat_update(n_steps):
    model = _model()
    params = _params_tree(model)
    jstate = _seeded_flat_state(params)
    opt = FlatAdamW(model.parameters())
    opt.load_state_dict(from_jax_flat_opt({"m": np.asarray(jstate.m), "v": np.asarray(jstate.v),
                                           "count": np.asarray(jstate.count)}, params, model))
    step = jax.jit(jax_flat_step)
    jparams = params
    for g in _grad_trees(params, n_steps):
        jparams, jstate = step(jstate, g, jparams, jnp.float32(LR))
        _set_grads(model, g)
        apply_optimizer(opt, LR)
    got = to_jax_paths(dict(model.named_parameters()), model)
    want = {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(jparams).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=k)
    back = to_jax_flat_opt(opt.state_dict(), params, model)
    np.testing.assert_allclose(back["m"], np.asarray(jstate.m), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(back["v"], np.asarray(jstate.v), rtol=RTOL, atol=ATOL)
    assert int(back["count"]) == int(jstate.count) == 3 + n_steps


def test_flat_state_bridge_round_trips():
    model = _model()
    params = _params_tree(model)
    jstate = _seeded_flat_state(params)
    raw = {"m": np.asarray(jstate.m), "v": np.asarray(jstate.v), "count": np.asarray(3)}
    port = from_jax_flat_opt(raw, params, model)
    assert not np.array_equal(port["m"].numpy(), raw["m"])      # another raveling
    back = to_jax_flat_opt(port, params, model)
    for k in ("m", "v"):
        np.testing.assert_array_equal(back[k], raw[k])
    with pytest.raises(ValueError, match="entries"):
        from_jax_flat_opt({**raw, "m": raw["m"][:-1]}, params, model)


def test_flat_adamw_matches_the_per_leaf_adamw_over_20_steps():
    flat_model, leaf_model = _model(), _model()
    flat = TrainState.create(flat_model, flat_opt=True).opt_cls
    leaf = TrainState.create(leaf_model, flat_opt=False).opt_cls
    assert isinstance(flat, FlatAdamW) and isinstance(leaf, torch.optim.AdamW)
    for g in _grad_trees(_params_tree(flat_model), 20):
        for model, opt in ((flat_model, flat), (leaf_model, leaf)):
            _set_grads(model, g)
            apply_optimizer(opt, LR)
    for (name, a), (_, b) in zip(flat_model.named_parameters(), leaf_model.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_flat_adamw_steps_its_buffers_in_place():
    """Each optimizer of a flat state keeps its moments, count and raveled
    buffers from step to step (a CUDA graph can replay the update), and the
    parameters keep their own tensors."""
    model = _model()
    state = TrainState.create(model, True, True, flat_opt=True)
    opts = (state.opt_cls, state.opt_ssl, state.opt_cm)
    params = [p.data_ptr() for p in model.parameters()]

    def ptrs():
        return [(o.m.data_ptr(), o.v.data_ptr(), o.count.data_ptr(), o.flat.data_ptr(),
                 o.grad.data_ptr()) for o in opts]

    seen = []
    for g in _grad_trees(_params_tree(model), 3):
        _set_grads(model, g)
        for opt in opts:
            apply_optimizer(opt, LR)
        seen.append(ptrs())
    assert seen[0] == seen[1] == seen[2]
    assert [p.data_ptr() for p in model.parameters()] == params
    assert all(torch.equal(p.reshape(-1), piece) for p, piece in
               zip(model.parameters(), opts[-1].flat.split([p.numel() for p in model.parameters()])))


def test_a_replaced_parameter_stays_the_one_updated():
    """A parameter whose ``.data`` is replaced between steps (as
    ``shard_params`` and ``Module.to`` replace it) is the one the next step
    updates, and the steps go on bit for bit."""
    a, b = _model(), _model()
    oa, ob = FlatAdamW(a.parameters()), FlatAdamW(b.parameters())
    for i, g in enumerate(_grad_trees(_params_tree(a), 3)):
        if i == 1:
            for p in b.parameters():
                p.data = p.data.clone()
        for model, opt in ((a, oa), (b, ob)):
            _set_grads(model, g)
            opt.step(LR)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert torch.equal(oa.m, ob.m) and torch.equal(oa.v, ob.v)


def test_a_none_gradient_counts_as_zeros():
    a, b = _model(), _model()
    oa, ob = FlatAdamW(a.parameters()), FlatAdamW(b.parameters())
    for p in b.parameters():
        p.grad = torch.zeros_like(p)
    oa.step(LR)
    ob.step(LR)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert torch.equal(oa.v, ob.v) and int(oa.count) == 1


def test_flat_opt_flag_builds_flat_optimizers(monkeypatch):
    """DRUGLAMP_FLAT_OPT=1 (as the JAX package's ``TrainState.create``):
    flat optimizers for every gate, and one full-gate step through them."""
    model = _model("DrugLAMP2C2P")
    monkeypatch.setenv("DRUGLAMP_FLAT_OPT", "1")
    state = TrainState.create(model, True, True)
    assert all(isinstance(o, FlatAdamW) for o in (state.opt_cls, state.opt_ssl, state.opt_cm))
    monkeypatch.setenv("DRUGLAMP_FLAT_OPT", "0")
    assert isinstance(TrainState.create(model).opt_cls, torch.optim.AdamW)
    assert isinstance(TrainState.create(model, flat_opt=True).opt_cls, FlatAdamW)
    b = _batch()
    out = steps.make_train_step(model, True, True, calibrate=True, device="cpu")(
        state, b, torch.Generator().manual_seed(3), *LRS)
    assert all(np.isfinite(float(x)) for x in (out.cls_loss, out.ssl_loss, out.cm_loss))
    assert int(state.opt_cm.count) == 1 and float(state.opt_cls.v.abs().sum()) > 0


def _batch(b_size=6):
    b = synthetic.make_batch(_cfg(), b_size, seed=9, n_drug_feature=ND, n_prot_feature=NP)
    b["labels"] = np.array([1, 0, 0, 0, 1, 0], np.float32)[:b_size]
    b["cm"] = build_cm_arrays(np.arange(b_size) % 3, np.arange(b_size) % 4, b["labels"])
    return b


def _trainer(model, work):
    loader = types.SimpleNamespace(batch_size=6)
    return Trainer(model, _cfg(), loader, loader, loader, work_dir=str(work), device="cpu")


def test_flat_checkpoint_restores_fields_by_name_and_resumes_bit_for_bit(tmp_path):
    batch, gen_seed = _batch(), 7
    model = _model("DrugLAMP2C2P")
    state = TrainState.create(model, True, True, flat_opt=True)
    step = steps.make_train_step(model, True, True, calibrate=True, device="cpu")
    gen = torch.Generator().manual_seed(gen_seed)
    for _ in range(3):
        step(state, batch, gen, *LRS)
    tr = _trainer(model, tmp_path / "w")
    path = str(tmp_path / "w" / "ckpt_last.pt")
    tr._save(path, tr._snapshot(state))
    tr._join_ckpt()                    # the write runs on a thread of its own
    saved = torch.load(path, weights_only=True)["optim"]
    assert set(saved["opt_ssl"]) == {"m", "v", "count"} and int(saved["opt_ssl"]["count"]) == 3

    other = _model("DrugLAMP2C2P", seed=1)
    restored = TrainState.create(other, True, True, flat_opt=True)
    _trainer(other, tmp_path / "w").restore(path, restored)
    for name in ("opt_cls", "opt_ssl", "opt_cm"):
        a, b = getattr(state, name), getattr(restored, name)
        assert torch.equal(a.m, b.m) and torch.equal(a.v, b.v) and torch.equal(a.count, b.count)
    gen_b = torch.Generator().manual_seed(0)
    gen_b.set_state(gen.get_state())
    step_b = steps.make_train_step(other, True, True, calibrate=True, device="cpu")
    for _ in range(2):
        step(state, batch, gen, *LRS)
        step_b(restored, batch, gen_b, *LRS)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  other.state_dict().values()))
    assert torch.equal(state.opt_cm.v, restored.opt_cm.v)


def test_mismatched_optimizer_states_raise():
    model = _model()
    flat = TrainState.create(model, flat_opt=True)
    leaf = TrainState.create(model, flat_opt=False)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    apply_optimizer(leaf.opt_cls, LR)
    with pytest.raises(ValueError, match="per-leaf AdamW state for a flat optimizer"):
        flat.load_state_dict(leaf.state_dict())
    with pytest.raises(ValueError, match="flat AdamW state for a per-leaf optimizer"):
        leaf.load_state_dict(flat.state_dict())
    small = FlatAdamW(list(model.parameters())[:2])
    with pytest.raises(ValueError, match="entries"):
        flat.opt_cls.load_state_dict(small.state_dict())
    small.params = list(model.parameters())
    with pytest.raises(ValueError, match="moments for"):
        small.step(LR)


# --- shard_state of a flat state over a model axis of two ranks ----------------------------

def _sharded_names():
    model = build_model("DrugLAMP2C2P", _cfg(), ND, NP)
    return {f"{path}.{k}" for path, splits in tp_plan(model, 2).items() for k in splits}


def _adamw_flat(first, moments, step):
    """The parameters that the three flat AdamWs (cls → ssl → cm at LRS)
    make of ``first`` with ``moments`` at step ``step``, in f64."""
    out = {}
    for name in moments["opt_cls"]["exp_avg"]:
        p = first[name].astype(np.float64)
        for opt, lr in zip(("opt_cls", "opt_ssl", "opt_cm"), LRS[:3]):
            m, v = (moments[opt][k][name].astype(np.float64) for k in ("exp_avg", "exp_avg_sq"))
            u = m / (1 - B1 ** step) / (np.sqrt(v / (1 - B2 ** step)) + EPS) + WEIGHT_DECAY * p
            p = p - lr * u
        out[name] = p
    return out


@pytest.fixture(scope="module")
def flat_tp(tmp_path_factory):
    d = tmp_path_factory.mktemp("flat_tp")
    host = synthetic.make_batch(_cfg(), 8, seed=3, n_drug_feature=ND, n_prot_feature=NP)
    batch = compact_batch(host, (host["d_fill"] == 0).sum(1))
    t = np.arange(8)
    batch["labels"] = ((t % 3 == 0) | (t == 7)).astype(np.float32)
    batch["cm"] = build_cm_arrays(t % 3, t % 5, batch["labels"])
    with open(os.path.join(d, "flat_tp.pkl"), "wb") as f:
        pickle.dump({"cfg": _cfg(0.1), "nd": ND, "np": NP, "batch": batch, "lrs": LRS}, f)
    run_ranks(RANKS + ["flat_tp", str(d)], timeout=300)
    runs = []
    for rank in range(2):
        with open(os.path.join(d, f"rank{rank}_flat_tp.pkl"), "rb") as f:
            runs.append(pickle.load(f))
    return runs


@pytest.mark.parametrize("grad_mode", steps.GRAD_MODES)
def test_shard_state_cuts_a_flat_state(flat_tp, grad_mode):
    one = flat_tp[0][grad_mode]["one"]
    for name, want in _adamw_flat(one["first"], one["moments"], 2).items():
        np.testing.assert_allclose(one["local"][name], want, rtol=0, atol=1e-6, err_msg=name)
    runs = [out[grad_mode] for out in flat_tp]
    assert set(runs[0]["split"]) == _sharded_names()
    for run in runs:
        tp = run["tp"]
        assert tp["count"] == one["count"] == 2
        assert all(np.array_equal(v, one["first"][k]) for k, v in tp["first"].items())
        np.testing.assert_allclose(tp["losses"], one["losses"], rtol=0, atol=1e-5)
        for opt in one["moments"]:
            for key, scale in (("exp_avg", lambda m: m / (1 - B1 ** 2)),
                               ("exp_avg_sq", lambda v: np.sqrt(v / (1 - B2 ** 2)))):
                for name, v in one["moments"][opt][key].items():
                    np.testing.assert_allclose(scale(tp["moments"][opt][key][name]), scale(v),
                                               rtol=5e-3, atol=5e-5, err_msg=f"{opt} {key} {name}")
        for name, want in _adamw_flat(one["first"], tp["moments"], 2).items():
            np.testing.assert_allclose(tp["whole"][name], want, rtol=0, atol=1e-6, err_msg=name)
    for name, v in runs[0]["tp"]["local"].items():
        if name not in runs[0]["split"]:
            assert np.array_equal(v, runs[1]["tp"]["local"][name]), name
