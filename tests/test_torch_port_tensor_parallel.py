"""The model mesh axis of the port (druglamp_tpu_torch/parallel/mesh.py: the
(data, model) grid, ``shard_params`` / ``gather_params``, Megatron tensor
parallelism of PMMA and the MLP head; encoders/sharding.py: column-parallel
ESM-2; the CLI's ``--mesh-model``) on gloo ranks on the CPU, at the tiny
widths of the parity tests, f32, the fixed MLM mask of
tests/torch_port_ranks.py.

- One process: the grid's divisibility error; ``tp_plan``'s fallback (a
  module whose heads or hidden units do not divide by the model axis stays
  replicated whole).
- Two ranks (1 × 2; tests/torch_port_ranks.py ``tp``): the grid and its
  groups; ``build_model(mesh=)`` then ``gather_params`` gives the whole
  model bit for bit, each rank holding half of every sharded leaf; the cls
  and the full-gate ``loss_gradients`` with dropout on against the port's
  one-process step from the same generator (losses 1e-5, gathered
  gradients rtol 5e-3 / atol 5e-5); one full-gate step in each grad mode:
  the replicated leaves bit-identical on both ranks, each AdamW's first
  moment, gathered, the gradient it applied (at the gradient tolerance);
  two full-gate steps in each grad mode, ``shard_state`` between them: the
  moments after the second step at the gradient tolerance of two
  one-process steps', and the gathered parameters exactly the AdamW update
  of those moments (1e-6); the cls step from the JAX reference's flax trees
  (``convert.load_jax_params_sharded``) at dropout 0 against JAX's
  ``shard_state`` step on a (1, 2) mesh of the conftest's virtual CPU
  devices (the JAX test's rel 1e-5); ESM-2 column-parallel within 2e-5 of one process, with heads that
  divide and with heads that do not (its attention then replicated), and
  ``generate_embeddings`` over the grid: rank 0's caches within 2e-5 of one
  process's.
- Four ranks (2 × 2; ``tp4``): the grid; ``loss_gradients`` and one
  full-gate step in both BatchNorm modes against the one-process step on
  the whole batch (global statistics and CM mining over the data group;
  per_replica one group a data rank), dropout 0; the ranks that share a
  model rank hold the same parameters, and the replicated ones are the same
  on all four; ``generate_embeddings``: ESM-2 built and run by rank 0's
  model group only, its caches those of the 1 × 2 grid.
- The CLI with ``--mesh-model 2`` on two ranks gives the one-process run's
  records value for value (n_data 1), rank 0 alone writing.
"""

import concurrent.futures
import dataclasses
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from druglamp_tpu.models.registry import build_model as jax_build_model
from druglamp_tpu.parallel.mesh import MeshContext as JMeshContext
from druglamp_tpu.parallel.mesh import make_mesh as jmake_mesh
from druglamp_tpu.train.state import TrainState as JTrainState
from druglamp_tpu.train.steps import make_train_step as jax_make_train_step
from druglamp_tpu_torch.data.cache import EmbeddingCache
from druglamp_tpu_torch.data.encoding import compact_batch
from druglamp_tpu_torch.data.loader import build_cm_arrays
from druglamp_tpu_torch.encoders import embed_pipeline, esm2
from druglamp_tpu_torch.encoders.chemberta import ChemBERTaConfig
from druglamp_tpu_torch.losses import masking
from druglamp_tpu_torch.models.registry import build_model
from druglamp_tpu_torch.parallel.mesh import (COLUMN, HALVES, ROW, join, make_mesh,
                                              param_spec, piece, tp_plan)
from druglamp_tpu_torch.train.state import B1, B2, EPS, WEIGHT_DECAY
from druglamp_tpu_torch.utils.synthetic import make_batch
from tests.torch_port_ranks import fixed_mask, run_ranks
from tests.torch_port_util import ND, NP, build_pair, port_config, tiny_cfg

B = 8
LRS = (1e-3, 3e-4, 1e-4, 0.5, 1.0)          # cls, ssl, cm, margin, CM weight
ESM = {"heads": dict(num_layers=2, embed_dim=32, num_heads=4, ffn_dim=64),
       "fallback": dict(num_layers=2, embed_dim=48, num_heads=3, ffn_dim=96)}
CHEMBERTA = dict(vocab=600, hidden=ND, num_layers=1, num_heads=2, intermediate=32,
                 max_positions=40)
PROTEINS = {"MKTAYIAKQRQISFVKSHFSRQ": 0, "GSHMLEDPVAGTQ": 1, "MVLSPADKTNVKAAW": 2}
DRUGS = {"CCO": 0, "c1ccccc1O": 1, "CC(=O)Nc1ccc(O)cc1": 2}


def _cfg(dropout):
    return dataclasses.replace(port_config(tiny_cfg()), pmma_dropout=dropout)


def _sharded_names():
    model = build_model("DrugLAMP2C2P", _cfg(0.0), ND, NP)
    return {f"{path}.{k}" for path, splits in tp_plan(model, 2).items() for k in splits}


def _batch(grouped=False):
    """A compact batch of B with CM ground truth (whole, or one block per half)."""
    host = make_batch(_cfg(0.0), B, seed=3, n_drug_feature=ND, n_prot_feature=NP)
    batch = compact_batch(host, (host["d_fill"] == 0).sum(1))
    t = np.arange(B)
    pid, did = t % 3, t % 5
    batch["labels"] = ((t % 3 == 0) | (t == 7)).astype(np.float32)
    if grouped:
        halves = [build_cm_arrays(pid[s], did[s], batch["labels"][s])
                  for s in (slice(0, B // 2), slice(B // 2, B))]
        batch["cm"] = {k: np.stack([h[k] for h in halves]) for k in halves[0]}
    else:
        batch["cm"] = build_cm_arrays(pid, did, batch["labels"])
    return batch


def _run(job, world, d):
    return run_ranks([sys.executable, "-m", "tests.torch_port_ranks", job, d], world=world,
                     timeout=400)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both rank jobs, started together → {"tp": [rank 0, rank 1], "tp4": [...]}."""
    jmodel, params, stats, _ = build_pair("DrugLAMP2C2P", tiny_cfg())
    jax_batch = make_batch(_cfg(0.0), B, seed=4, n_drug_feature=ND, n_prot_feature=NP)
    d2, d4 = (str(tmp_path_factory.mktemp(n)) for n in ("tp", "tp4"))
    r = np.random.RandomState(0)
    tokens = r.randint(4, 24, size=(3, 12)).astype(np.int64)
    tokens[:, 0], tokens[1, 9:] = 0, 1
    with open(os.path.join(d2, "tp.pkl"), "wb") as f:
        pickle.dump({"n_model": 2, "cfg": _cfg(0.1), "cfg0": _cfg(0.0), "nd": ND, "np": NP,
                     "batch": _batch(), "lrs": LRS, "jax_batch": jax_batch,
                     "jax_params": jax.tree.map(np.asarray, params),
                     "jax_stats": jax.tree.map(np.asarray, stats),
                     "esm": ESM, "esm_tokens": tokens, "proteins": PROTEINS, "drugs": DRUGS,
                     "chemberta": CHEMBERTA}, f)
    with open(os.path.join(d4, "tp4.pkl"), "wb") as f:
        pickle.dump({"cfg0": _cfg(0.0), "nd": ND, "np": NP,
                     "cases": {"global": {"bn_groups": 1, "batch": _batch()},
                               "per_replica": {"bn_groups": 2, "batch": _batch(True)}},
                     "esm": ESM, "proteins": PROTEINS, "drugs": DRUGS,
                     "chemberta": CHEMBERTA}, f)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(_run, "tp", 2, d2), pool.submit(_run, "tp4", 4, d4)]
        # the JAX reference meanwhile: the cls step on a (1, 2) mesh, model axis sharded
        state = JTrainState.create({"params": params, "batch_stats": stats}, use_ssl=False,
                                   use_cm=False)
        ctx = JMeshContext(jmake_mesh(2, jax.devices()[:2]), tensor_parallel=True)
        step = jax_make_train_step(jmodel, use_ssl=False, use_cm=False)
        out = step(ctx.shard_state(state), ctx.shard_batch(jax.tree.map(jnp.asarray, jax_batch)),
                   jax.random.key(3), *(jnp.float32(x) for x in LRS))
        jax_cls = float(out.cls_loss)
        for fut in futures:
            fut.result()
    load = lambda d, job, n: [pickle.load(open(os.path.join(d, f"rank{r}_{job}.pkl"), "rb"))
                              for r in range(n)]
    return {"tp": load(d2, "tp", 2), "tp4": load(d4, "tp4", 4), "jax_cls": jax_cls,
            "cache": os.path.join(d2, "cache"), "cache4": os.path.join(d4, "cache")}


def _assert_grads(got, ref):
    assert got.keys() == ref.keys()
    for loss in ref:
        assert got[loss].keys() == ref[loss].keys()
        for name, want in ref[loss].items():
            np.testing.assert_allclose(got[loss][name], want, rtol=5e-3, atol=5e-5,
                                       err_msg=f"{loss} {name}")


def _assert_moments(got, want, step):
    """Each AdamW's moments after ``step`` steps as gradients, at the
    gradient tolerance: the first moment over 1 − β1^step (after one step,
    the gradient applied), the root of the second over 1 − β2^step."""
    assert got.keys() == want.keys()
    for opt in want:
        for key, scale in (("exp_avg", lambda m: m / (1 - B1 ** step)),
                           ("exp_avg_sq", lambda v: np.sqrt(v / (1 - B2 ** step)))):
            assert got[opt][key].keys() == want[opt][key].keys()
            for name, v in want[opt][key].items():
                np.testing.assert_allclose(scale(got[opt][key][name]), scale(v), rtol=5e-3,
                                           atol=5e-5, err_msg=f"{opt} {key} {name}")


def _adamw(first, moments, step):
    """The parameters that the three AdamWs (cls → ssl → cm at LRS,
    train/state.py's settings) make of ``first`` with ``moments`` at step
    ``step``, in f64."""
    out = {}
    for name in moments["opt_cls"]["exp_avg"]:
        p = first[name].astype(np.float64)
        for opt, lr in zip(("opt_cls", "opt_ssl", "opt_cm"), LRS):
            m, v = (moments[opt][k][name].astype(np.float64) for k in ("exp_avg", "exp_avg_sq"))
            p = p * (1 - lr * WEIGHT_DECAY) - lr / (1 - B1 ** step) * m / (
                np.sqrt(v) / np.sqrt(1 - B2 ** step) + EPS)
        out[name] = p
    return out


# --- one process ----------------------------------------------------------------------------

def test_a_model_axis_must_divide_the_ranks():
    assert make_mesh(1).n_model == 1
    with pytest.raises(ValueError, match="do not divide into a model axis of 2"):
        make_mesh(2)


def test_tp_plan_falls_back_module_by_module():
    """At M=2 every rule's module shards; at M=3 nothing divides (4 heads,
    4E hidden units, 64 classifier units); an ESM-2 of 3 heads keeps its
    attention whole and shards its FFN."""
    from druglamp_tpu_torch.encoders.sharding import ESM_RULES

    model = build_model("DrugLAMP2C2P", _cfg(0.0), ND, NP)
    plan = tp_plan(model, 2)
    assert sorted(plan) == sorted(
        [f"pmma.block_{i}.{m}" for i in range(2) for m in ("attn", "ffn", "ffn_mol")]
        + [f"pmma.block_{i}.{m}" for i in (2, 3) for m in ("attn", "ffn")] + ["mlp_classifier"])
    assert plan["pmma.block_0.attn"]["fc.weight"] == HALVES
    assert "out.weight" not in plan["pmma.block_0.attn"]
    assert plan["pmma.block_2.attn"]["out.weight"] == ROW
    assert plan["mlp_classifier"]["bn1.running_var"] == COLUMN
    assert tp_plan(model, 3) == {} and tp_plan(model, 1) == {}
    assert param_spec("pmma.block_0.attn.fc_mol.weight", model, 2) == HALVES
    assert param_spec("pmma.block_0.attn.out.weight", model, 2) is None
    assert param_spec("pmma.block_3.ffn.fc1.bias", model, 2) == COLUMN
    assert param_spec("pmma.block_3.ffn.fc1.bias", model, 3) is None
    enc = esm2.ESM2(esm2.ESM2Config(**ESM["fallback"]))
    assert sorted(tp_plan(enc, 2, ESM_RULES)) == ["layers.0", "layers.1"]


@pytest.mark.parametrize("kind", [COLUMN, ROW, HALVES])
def test_pieces_join_to_the_whole(kind):
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    parts = [piece(t, kind, 2, m) for m in range(2)]
    assert all(p.numel() == t.numel() // 2 for p in parts)
    assert torch.equal(join(parts, kind), t)
    if kind == HALVES:
        assert parts[1][0].tolist() == [3.0, 4.0, 5.0, 9.0, 10.0, 11.0]


# --- two ranks (1 × 2) -----------------------------------------------------------------------

def test_grid_of_two_ranks(ranks):
    for r, out in enumerate(ranks["tp"]):
        assert out["grid"] == {"n_data": 1, "rank": 0, "n_model": 2, "model_rank": r,
                               "primary": r == 0, "data_group": [r], "model_group": [0, 1]}


def test_shard_then_gather_round_trips(ranks):
    """Each sharded leaf holds half its rows or columns; gathered back they
    are the whole model's bit for bit."""
    whole = build_model("DrugLAMP2C2P", _cfg(0.1), ND, NP).state_dict()
    for out in ranks["tp"]:
        assert out["roundtrip"] == []
        assert out["split"]["pmma.block_0.attn.fc.weight"] == HALVES
        for name, shape in out["local_shapes"].items():
            kind = out["split"].get(name)
            want = tuple(whole[name].shape)
            if kind == COLUMN:
                want = (want[0] // 2,) + want[1:]
            elif kind is not None:
                want = (want[0], want[1] // 2)
            assert shape == want, name


@pytest.mark.parametrize("gate", ["cls", "full"])
def test_tensor_parallel_gradients_match_one_process(ranks, gate):
    """Dropout on: both ranks draw the whole masks from one generator."""
    for out in ranks["tp"]:
        (got_l, got), (ref_l, ref) = out[gate]["tp"], out[gate]["one"]
        np.testing.assert_allclose(got_l, ref_l, rtol=0, atol=1e-5)
        _assert_grads(got, ref)


@pytest.mark.parametrize("grad_mode", ["per_loss", "legacy_aliased"])
def test_tensor_parallel_step_keeps_replicated_leaves_identical(ranks, grad_mode):
    a, b = (out["step"][grad_mode]["tp"] for out in ranks["tp"])
    split = ranks["tp"][0]["split"]
    assert set(split) == _sharded_names()
    for name, v in a["local"].items():
        if name not in split:
            assert np.array_equal(v, b["local"][name]), name
    one = ranks["tp"][0]["step"][grad_mode]["one"]
    np.testing.assert_allclose(a["losses"], one["losses"], rtol=0, atol=1e-5)
    assert a["w"] == one["w"] and a["losses"] == b["losses"]
    # AdamW's first step moves each entry by about ±lr a loss whatever the
    # gradient's size, so the parameters bound the update only by 2·lr a
    # loss; the first moments hold the gradients each optimizer applied
    reach = 2.1 * sum(LRS[:3])
    for name, want in one["local"].items():
        assert np.all(np.abs(a["whole"][name] - want) <= reach), name
    for out in ranks["tp"]:
        _assert_moments(out["step"][grad_mode]["tp"]["moments"], one["moments"], 1)


@pytest.mark.parametrize("grad_mode", ["per_loss", "legacy_aliased"])
def test_shard_state_then_a_sharded_step_matches_two_one_process_steps(ranks, grad_mode):
    """One whole step, ``shard_state`` (parameters and their AdamW moments
    cut), a second step sharded: the moments held to two one-process steps'
    at the gradient tolerance, and the gathered parameters the AdamW update
    of those moments, so the applied update is the one process's."""
    one = ranks["tp"][0]["shard_state"][grad_mode]["one"]
    for name, want in _adamw(one["first"], one["moments"], 2).items():
        np.testing.assert_allclose(one["local"][name], want, rtol=0, atol=1e-6, err_msg=name)
    runs = [out["shard_state"][grad_mode] for out in ranks["tp"]]
    assert set(runs[0]["split"]) == _sharded_names()
    for run in runs:
        tp = run["tp"]
        assert all(np.array_equal(v, one["first"][k]) for k, v in tp["first"].items())
        np.testing.assert_allclose(tp["losses"], one["losses"], rtol=0, atol=1e-5)
        _assert_moments(tp["moments"], one["moments"], 2)
        for name, want in _adamw(one["first"], tp["moments"], 2).items():
            np.testing.assert_allclose(tp["whole"][name], want, rtol=0, atol=1e-6, err_msg=name)
    for name, v in runs[0]["tp"]["local"].items():
        if name not in runs[0]["split"]:
            assert np.array_equal(v, runs[1]["tp"]["local"][name]), name


def test_tensor_parallel_cls_step_matches_the_jax_mesh(ranks):
    """Dropout 0, the JAX reference's weights: the cls loss of the port's
    two ranks against JAX's ``shard_state`` step on a (1, 2) mesh."""
    for out in ranks["tp"]:
        assert out["jax_cls"]["tp"] == pytest.approx(ranks["jax_cls"], rel=1e-5)
        assert out["jax_cls"]["one"] == pytest.approx(ranks["jax_cls"], rel=1e-5)


@pytest.mark.parametrize("name", list(ESM))
def test_column_parallel_esm_matches_one_process(ranks, name):
    for r, out in enumerate(ranks["tp"]):
        run = out["esm"][name]
        np.testing.assert_allclose(run["tp"], run["one"], rtol=0, atol=2e-5)
        sharded_attn = any("self_attn" in k for k in run["split"])
        assert sharded_attn == (name == "heads") and "layers.0.fc1.weight" in run["split"]


def test_generate_embeddings_over_the_grid_matches_one_process(ranks, tmp_path, monkeypatch):
    monkeypatch.setattr(masking, "mlm_mask", fixed_mask)
    monkeypatch.setitem(esm2._ESM2_SIZES, 12, esm2.ESM2Config(**ESM["heads"]))
    monkeypatch.setattr(embed_pipeline, "_BUCKETS", (48,))
    monkeypatch.setattr(embed_pipeline, "_DRUG_BUCKETS", (32,))
    table = types.SimpleNamespace(prot2ord=PROTEINS, drug2ord=DRUGS)
    cache = EmbeddingCache(str(tmp_path), "toy", ND, 32)
    embed_pipeline.generate_embeddings(table, cache, n_layer=12, device="cpu", verbose=False,
                                       chemberta_cfg=ChemBERTaConfig(**CHEMBERTA))
    want = sorted(os.listdir(tmp_path))
    assert sorted(os.listdir(ranks["cache"])) == want and len(want) == 6
    for f in want:
        np.testing.assert_allclose(np.load(os.path.join(ranks["cache"], f)),
                                   np.load(os.path.join(tmp_path, f)), rtol=0, atol=2e-5,
                                   err_msg=f)


# --- four ranks (2 × 2) ----------------------------------------------------------------------

def test_grid_of_four_ranks(ranks):
    for r, out in enumerate(ranks["tp4"]):
        d, m = divmod(r, 2)
        assert out["grid"] == {"n_data": 2, "rank": d, "n_model": 2, "model_rank": m,
                               "primary": r == 0, "data_group": [m, m + 2],
                               "model_group": [2 * d, 2 * d + 1]}


@pytest.mark.parametrize("mode", ["global", "per_replica"])
def test_data_and_model_axes_match_one_process(ranks, mode):
    ref_l, ref = ranks["tp4"][0][mode]["one"]
    for out in ranks["tp4"]:
        got_l, got = out[mode]["tp"]
        np.testing.assert_allclose(got_l, ref_l, rtol=0, atol=1e-5)
        _assert_grads(got, ref)
    states = [out[mode]["local"] for out in ranks["tp4"]]
    sharded = _sharded_names()
    for name, v in states[0].items():
        assert np.array_equal(v, states[2][name]), name           # one model rank
        assert np.array_equal(states[1][name], states[3][name]), name
        if name not in sharded:
            assert np.array_equal(v, states[1][name]), name       # replicated


def test_generate_embeddings_runs_esm_on_model_group_zero_only(ranks):
    """Over 2 × 2 ranks the model group of data rank 0 runs ESM-2
    column-parallel and rank 0 writes; data rank 1's ranks build no ESM-2."""
    assert [out["esm_built"] for out in ranks["tp4"]] == [1, 1, 0, 0]
    want = sorted(os.listdir(ranks["cache"]))
    assert sorted(os.listdir(ranks["cache4"])) == want and len(want) == 6
    for f in want:
        np.testing.assert_allclose(np.load(os.path.join(ranks["cache4"], f)),
                                   np.load(os.path.join(ranks["cache"], f)), rtol=0, atol=2e-5,
                                   err_msg=f)


# --- the CLI ----------------------------------------------------------------------------------

def test_cli_mesh_model_two_ranks_gives_the_one_process_records(tmp_path):
    from druglamp_tpu_torch.cli import main as cli
    from tests.test_torch_port_cli import TINY_YAML, TIMES, _argv, _strip
    from tests.test_torch_port_trainer import _records, _toy_dataset

    root = _toy_dataset(str(tmp_path / "data"))
    yaml = os.path.join(root, "tiny.yaml")
    with open(yaml, "w") as f:
        f.write(TINY_YAML)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert cli.main(_argv(root, yaml, one)) == 0
    outs = run_ranks([sys.executable, "-m", "druglamp_tpu_torch.cli.main"]
                     + _argv(root, yaml, two) + ["--mesh-model", "2"], timeout=600)
    got, want = (_records(os.path.join(w, "metrics.jsonl")) for w in (two, one))
    assert _strip(got) == _strip(want)
    hp = {k: v for k, v in got[0].items() if k not in TIMES}
    assert hp == {k: v for k, v in want[0].items() if k not in TIMES} and hp["ranks"] == 1
    assert "test_auroc" in outs[0][0] and "test_auroc" not in outs[1][0]
    for name in ("ckpt_best.pt", "ckpt_last.pt"):
        a, b = (torch.load(os.path.join(w, name), weights_only=True) for w in (two, one))
        assert all(torch.equal(a["model"][k], b["model"][k]) for k in b["model"]), name
