"""Data-parallel training of the port (druglamp_tpu_torch/parallel/: the
process group, ``MeshContext``; per-replica and global BatchNorm; both CM
mining modes; the Trainer and the CLI over several ranks) against the JAX
package on the CPU at fp32 and a tiny DrugLAMP2C2P, dropout 0, the fixed MLM
mask of tests/test_torch_port_ssl_cm.py injected into both packages.  The
ranks are processes of a gloo group started as torchrun starts them
(``tests/torch_port_ranks.py``); the JAX package runs its step on a
2-device mesh of the conftest's virtual CPU devices.

- Grouped ``TorchBatchNorm`` and ``MaskedBatchNorm`` (groups 2 and 4):
  outputs and running stats against JAX's, 1e-6.  ``CrossModality(groups=2)``
  against JAX's: loss rel 1e-5.  The loader's ``cm_groups=2`` arrays bit for
  bit against the JAX loader's.
- One process, ``bn_groups=2``, the full-gate step (ssl, cm, calibrate)
  against the JAX step with ``bn_groups=2``: losses 1e-5, gradients rtol
  5e-3 / atol 5e-5, parameters after the step as
  tests/test_torch_port_ssl_cm.py holds them (``_assert_params_close`` at
  rtol 5e-3 / atol 5e-5 where both packages' gradients give the same AdamW
  first-step direction, within the LRs' reach elsewhere), running stats 1e-6.
- Two ranks, the full-gate step on a batch of 8 whose halves hold proteins
  of different lengths (the ranks mask different numbers of MLM tokens):
  global mode against the JAX step on the mesh, per_replica against the
  JAX ``bn_groups=2`` step on the mesh, each in both grad modes, to the
  same tolerances; both ranks' parameters bit-identical.
- Two ranks of ``Trainer.fit`` (2 epochs: cls; ssl + cm + calibrate) on the
  gather transport and on host batches of ordinals against one rank's
  gather fit on the same global batches: each epoch's metrics and the test metrics
  1e-5; only rank 0 writes checkpoints; a resume from the epoch-1
  ``ckpt_last.pt`` gives epoch 2's parameters bit for bit on both ranks.
- The CLI under two ranks with ``--bn-mode per_replica`` trains over the
  host pipeline, rank 0 writing the logs and checkpoints.
- One process: ``MeshContext``'s row shards, ``make_mesh``'s refusal of a
  model axis that does not divide the ranks, and the process-group guard (a no-op without torchrun's
  variables; NCCL refuses two ranks on one card before any rank waits, and
  the CLI's own call gives each local rank its card).
"""

import concurrent.futures
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import druglamp_tpu.data.encoding as jenc
import druglamp_tpu.models.ssl as jssl
import druglamp_tpu.utils.synthetic as jsyn
from druglamp_tpu.data.loader import build_cm_arrays
from druglamp_tpu.models import cm as jcm
from druglamp_tpu.models.registry import build_model as jax_build_model
from druglamp_tpu.nn.layers import MaskedBatchNorm as JMaskedBatchNorm
from druglamp_tpu.nn.layers import TorchBatchNorm as JTorchBatchNorm
from druglamp_tpu.parallel.mesh import MeshContext as JMeshContext
from druglamp_tpu.parallel.mesh import make_mesh as jmake_mesh
from druglamp_tpu_torch.convert import from_jax_params, to_jax_paths
from druglamp_tpu_torch.data.cache import EmbeddingCache
from druglamp_tpu_torch.data.encoding import decode_batch
from druglamp_tpu_torch.losses import masking as pmask
from druglamp_tpu_torch.models import cm as pcm
from druglamp_tpu_torch.models.registry import build_model as port_build_model
from druglamp_tpu_torch.nn.layers import MaskedBatchNorm, TorchBatchNorm
from druglamp_tpu_torch.parallel.mesh import MeshContext, make_mesh
from druglamp_tpu_torch.train import steps as psteps
from druglamp_tpu_torch.train.state import TrainState
from tests.test_torch_port_ssl_cm import (CM_W0, GATES, LR, LR_CM, LR_SSL, MARGIN,
                                          _assert_params_close, _compose, _flat,
                                          _jax_fixed_mask, _jax_loss_grads, _pair,
                                          _port_fixed_mask)
from tests.test_torch_port_trainer import (JAX_BUILD, PORT_BUILD, _cfg, _full_port_config,
                                           _records, _toy_dataset, _world)
from tests.torch_port_ranks import run_ranks
from tests.torch_port_util import ND, NP, port_config, random_stats, tiny_cfg

B = 8
# the two ranks' halves: protein 0 has a positive and negatives in the whole
# batch and in the first half, proteins 1 and 2 only negatives in the first
# half (the fallback rows), protein 3 a positive and a negative in the second
PIDS = np.array([0, 1, 0, 2, 1, 3, 3, 0])
DIDS = np.array([0, 0, 1, 2, 3, 1, 4, 2])
LABELS = np.array([1, 0, 0, 0, 1, 0, 1, 0], np.float32)
MODES = {"global": 1, "per_replica": 2}
RANKS = [sys.executable, "-m", "tests.torch_port_ranks"]


# --- grouped layers, CrossModality, the loader -------------------------------------------

@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("layer", ["batchnorm", "masked"])
def test_grouped_batchnorm_matches_jax(layer, groups):
    r = np.random.RandomState(groups)
    x = r.randn(8, 3, 6).astype(np.float32) if layer == "batchnorm" else \
        r.randn(8, 6).astype(np.float32)
    x[: 8 // groups] += 2.0                       # block 0 (the running stats') differs
    mask = r.rand(8) > 0.3
    jmod = JTorchBatchNorm(groups=groups) if layer == "batchnorm" else \
        JMaskedBatchNorm(groups=groups)
    args = (jnp.asarray(x),) if layer == "batchnorm" else (jnp.asarray(x), jnp.asarray(mask))
    v = jmod.init(jax.random.key(0), *args, use_running_average=False)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.2 * r.randn(*a.shape).astype(np.float32),
                          v["params"])
    stats = random_stats(v["batch_stats"], r)
    port = TorchBatchNorm(6, groups=groups) if layer == "batchnorm" else \
        MaskedBatchNorm(6, groups=groups)
    port.load_state_dict(from_jax_params(params, stats, port))
    for train in (True, False):
        ref, muts = jmod.apply({"params": params, "batch_stats": stats}, *args,
                               use_running_average=not train, mutable=["batch_stats"])
        port.load_state_dict(from_jax_params(params, stats, port))
        got = port.train(train)(*(torch.from_numpy(np.asarray(a)) for a in args))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
        new = _flat(muts["batch_stats"])
        moved = to_jax_paths(port.state_dict(), port)
        for k, want in new.items():
            np.testing.assert_allclose(moved[k], want, rtol=0, atol=1e-6, err_msg=k)


def test_cross_modality_groups_match_jax():
    """Per-replica mining inside the DrugLAMP2C2P model's CM head (groups=2):
    each half mines its own triplets from its block of the ground truth."""
    jmodel, params, stats, _ = _pair("DrugLAMP2C2P")
    jmodel = jax_build_model("DrugLAMP2C2P", tiny_cfg(), ND, NP, bn_groups=2)
    model = port_build_model("DrugLAMP2C2P", port_config(tiny_cfg()), ND, NP, bn_groups=2)
    model.load_state_dict(from_jax_params(params, stats, model))
    r = np.random.RandomState(8)
    xs = [r.randn(B, 5, tiny_cfg().n_hidden).astype(np.float32) for _ in range(4)]
    cm = _grouped_cm()
    args = [cm[k] for k in ("p_index", "p_valid", "d_index", "d_valid", "gt")]
    ref, muts = jmodel.apply({"params": params, "batch_stats": stats},
                             *map(jnp.asarray, xs + args), jnp.float32(MARGIN),
                             method=lambda m, *a: m.cm_model(*a, train=True),
                             mutable=["batch_stats"])
    got = model.train().cm_model(*map(torch.from_numpy, xs + args), MARGIN)
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    port = to_jax_paths(model.state_dict(), model)
    for k, v in _flat(muts["batch_stats"]).items():
        np.testing.assert_allclose(port[k], v, rtol=0, atol=1e-6, err_msg=k)


def test_loader_cm_groups_match_jax(tmp_path):
    cfg = _cfg()
    root = _toy_dataset(str(tmp_path))
    (jl, _, _), _, _ = _world(root, cfg, JAX_BUILD)
    (pl, _, _), _, _ = _world(root, cfg, PORT_BUILD)
    jl.cm_groups = pl.cm_groups = 2
    for epoch in range(3):
        order = pl._order(epoch)
        for s in range(0, len(order) - pl.batch_size + 1, pl.batch_size):
            rows = order[s:s + pl.batch_size]
            got, ref = pl._assemble_compact(rows)["cm"], jl._assemble_compact(rows)["cm"]
            assert set(got) == set(ref)
            for k in ref:
                assert got[k].shape == (2, pl.batch_size // 2) + got[k].shape[2:]
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_mesh_shards_rows_and_refuses_tensor_parallelism():
    """One process: a mesh of one rank shards nothing; ``rows`` of rank r of
    N is the contiguous block, a leading dimension that does not divide
    stays whole; a model axis of 2 does not divide one process's single
    rank (the JAX ``make_mesh``'s divisibility assert), so it raises."""
    mesh = MeshContext(make_mesh(1))
    assert mesh.n_data == 1 and mesh.rank == 0
    batch = {"a": np.arange(6), "cm": {"gt": np.ones((6, 6))}, "s": np.float32(2)}
    assert mesh.shard_batch(batch)["a"].tolist() == list(range(6))
    two = MeshContext(type(mesh.mesh)(None, 2, 1))
    assert two.rows(8) == slice(4, 8) and two.rows(7) == slice(0, 7)
    sharded = two.shard_batch(batch, whole=("cm",))
    assert sharded["a"].tolist() == [3, 4, 5] and sharded["cm"]["gt"].shape == (6, 6)
    assert sharded["s"] == 2 and two.shard_batch(batch)["cm"]["gt"].shape == (3, 6)
    with pytest.raises(ValueError, match="1 rank\\(s\\) do not divide into a model axis of 2"):
        make_mesh(2)


def test_distributed_needs_torchrun_and_refuses_two_ranks_on_a_card_under_nccl(monkeypatch):
    """Without torchrun's variables joining is a no-op (one process, rank 0,
    primary).  With them, NCCL refuses before any rank waits for the others:
    two local ranks pinned to one card, more local ranks than cards, and a
    rank on the CPU; ``cuda`` is this rank's card ``cuda:LOCAL_RANK``."""
    from druglamp_tpu_torch.parallel import distributed

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.maybe_initialize_distributed("gloo", "cpu")
    assert distributed.process_count() == 1 and distributed.is_primary()
    assert distributed.rank_device("cuda") == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    assert distributed.rank_device("cuda") == torch.device("cuda", 1)
    assert distributed.rank_device("cuda:0") == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="one rank a card"):
        distributed.maybe_initialize_distributed("nccl", "cuda:0")
    with pytest.raises(RuntimeError, match="1 card"):
        distributed.maybe_initialize_distributed("nccl", "cuda")
    with pytest.raises(RuntimeError, match="gloo"):
        distributed.maybe_initialize_distributed("nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        distributed.maybe_initialize_distributed("mpi", "cpu")


class _Joined(Exception):
    """Raised by the stand-in for ``init_process_group``: the rank got there."""


@pytest.mark.parametrize("rank", [0, 1])
def test_cli_joins_nccl_with_one_card_a_rank(monkeypatch, rank):
    """The CLI's own call under torchrun with two local ranks on a machine of
    two cards: ``--device cuda`` (NCCL, the default) makes rank r's card
    ``cuda:r`` current and reaches ``init_process_group`` on every rank;
    ``--device cuda:0`` pins both ranks to one card and raises before it."""
    from druglamp_tpu_torch.cli import main as cli
    from druglamp_tpu_torch.parallel import distributed

    calls = []

    def init(backend, **kw):
        calls.append(("init", backend, kw["rank"], kw["world_size"]))
        raise _Joined

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(distributed.dist, "init_process_group", init)
    monkeypatch.delenv("DRUGLAMP_DIST_BACKEND", raising=False)
    for k, v in {"RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
                 "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    argv = ["--model", "DrugLAMP2C2P", "--data", "toy", "--data-root", "absent", "--device"]
    with pytest.raises(_Joined):
        cli.main(argv + ["cuda"])
    assert calls == [("set_device", rank), ("init", "nccl", rank, 2)]
    with pytest.raises(RuntimeError, match="one rank a card"):
        cli.main(argv + ["cuda:0"])
    assert len(calls) == 2


# --- the full-gate step: one process with bn_groups=2, and two ranks ----------------------

def _grouped_cm():
    halves = [build_cm_arrays(PIDS[s], DIDS[s], LABELS[s]) for s in (slice(0, 4), slice(4, 8))]
    return {k: np.stack([h[k] for h in halves]) for k in halves[0]}


def _batch(grouped: bool):
    """The global batch of 8: the second half's proteins keep one of their
    three tiles, so the halves mask different numbers of MLM tokens."""
    b = jsyn.make_batch(tiny_cfg(), B, seed=9, n_drug_feature=ND, n_prot_feature=NP)
    L = b["vp"].shape[1]
    b["vp"][B // 2:, L // 3:] = 0
    c = jenc.compact_batch(b, (b["d_fill"] == 0).sum(1))
    c["labels"] = LABELS.copy()
    c["cm"] = _grouped_cm() if grouped else build_cm_arrays(PIDS, DIDS, LABELS)
    return c


@pytest.fixture(scope="module")
def mesh_reference():
    """The JAX package on a 2-device mesh, per mode: the losses, per-loss
    gradients and running stats of the full-gate step's forward
    (``_jax_loss_grads``), and the step composed from them in both grad
    modes (``_compose``)."""
    _, params, stats, _ = _pair("DrugLAMP2C2P")
    ctx = JMeshContext(jmake_mesh(1, jax.devices()[:2]))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssl, "mlm_mask", _jax_fixed_mask)
        for mode, groups in MODES.items():
            jmodel = jax_build_model("DrugLAMP2C2P", tiny_cfg(), ND, NP, bn_groups=groups)
            fn = _jax_loss_grads(jmodel, True)
            run = jax.jit(lambda p, s, b: fn(p, s, jenc.decode_batch(dict(b))))
            batch = jax.tree.map(jnp.asarray, _batch(groups > 1))
            losses, grads, stages = run(ctx.replicate(params), ctx.replicate(stats),
                                        ctx.shard_batch(batch))
            losses = [np.float32(x) for x in losses]
            grads = jax.tree.map(np.asarray, grads)
            stages = jax.tree.map(np.asarray, stages)
            out[mode] = {"losses": losses, "grads": [_flat(g) for g in grads],
                         "stages": stages,
                         "steps": {gm: _compose(params, stats, losses, grads, stages,
                                                GATES["ssl_cm_calibrate"], gm)
                                   for gm in psteps.GRAD_MODES}}
    return out


def _port_state(groups):
    _, params, stats, _ = _pair("DrugLAMP2C2P")
    model = port_build_model("DrugLAMP2C2P", port_config(tiny_cfg()), ND, NP, bn_groups=groups)
    model.load_state_dict(from_jax_params(params, stats, model))
    return model


@pytest.fixture(scope="module")
def one_process():
    """The port's full-gate step with bn_groups=2 on the whole batch, in one
    process, in both grad modes; and its per-loss gradients."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pmask, "mlm_mask", _port_fixed_mask)
        batch = _tensors(_batch(True))
        model = _port_state(2).train()
        with psteps.train_numerics():
            *losses, _, _, grads = psteps.loss_gradients(
                model, decode_batch(dict(batch)), None, True, True, False, MARGIN,
                torch.ones(()))
        names = [n for n, _ in model.named_parameters()]
        out["losses"] = [float(x) for x in losses]
        out["grads"] = {k: {n: g.numpy() for n, g in zip(names, v)} for k, v in grads.items()}
        out["steps"] = {}
        for gm in psteps.GRAD_MODES:
            model = _port_state(2)
            state = TrainState.create(model, True, True)
            step = psteps.make_train_step(model, True, True, calibrate=True, grad_mode=gm,
                                          device="cpu")
            o = step(state, batch, None, LR, LR_SSL, LR_CM, MARGIN, CM_W0)
            out["steps"][gm] = {"state": {k: v.numpy() for k, v in model.state_dict().items()},
                                "losses": [float(o.cls_loss), float(o.ssl_loss),
                                           float(o.cm_loss)], "w": float(o.cm_weight)}
    return out


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def two_ranks(rank_runs):
    """Both modes' loss_gradients and full-gate steps on two gloo ranks."""
    return rank_runs["step"]


def _jax_paths(flat_by_name, groups=1):
    model = _port_state(groups)
    return to_jax_paths({k: torch.from_numpy(v) for k, v in flat_by_name.items()}, model)


def _check_losses(got_losses, got_steps, ref):
    cls, ssl, cm = ref["losses"]
    assert np.allclose(got_losses, [cls, ssl, cm], rtol=0, atol=1e-5), (got_losses, ref["losses"])
    for gm, run in got_steps.items():
        w = ref["steps"][gm][2]
        assert np.float32(run["w"]) == w, (gm, run["w"], w)
        want = [cls, ssl, cm * float(w)]
        assert np.allclose(run["losses"], want, rtol=0, atol=1e-5), (gm, run["losses"], want)


def _check_grads(got, ref, groups):
    for i, loss in enumerate(("cls", "ssl", "cm")):
        port = _jax_paths(got[loss], groups)
        assert set(port) == set(ref["grads"][i])
        for k, v in ref["grads"][i].items():
            np.testing.assert_allclose(port[k], v, rtol=5e-3, atol=5e-5, err_msg=f"{loss} {k}")


def _check_step(state, grads, ref, gm, groups):
    """The parameters after the step against the JAX composition where both
    packages' gradients give the same AdamW first-step direction (the
    others within the LRs' reach: ``_assert_params_close`` with the port's
    own gradients composed alike), the running stats 1e-6."""
    _, params, stats, _ = _pair("DrugLAMP2C2P")
    trees = [traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in
                                           _jax_paths(grads[loss], groups).items()})
             for loss in ("cls", "ssl", "cm")]
    port_applied = _compose(params, stats, ref["losses"], trees, ref["stages"],
                            GATES["ssl_cm_calibrate"], gm)[3]
    params, stats, _, applied = ref["steps"][gm]
    got = _jax_paths(state, groups)
    assert set(got) == set(params) | set(stats)
    _assert_params_close(got, params, applied, 5e-3, 5e-5, gm, port_applied)
    for k, v in stats.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=f"{gm} {k}")


def test_one_process_grouped_step_matches_jax(one_process, mesh_reference):
    ref = mesh_reference["per_replica"]
    _check_losses(one_process["losses"], one_process["steps"], ref)
    _check_grads(one_process["grads"], ref, 2)


@pytest.mark.parametrize("grad_mode", ["per_loss", "legacy_aliased"])
def test_one_process_grouped_parameters_match_jax(one_process, mesh_reference, grad_mode):
    _check_step(one_process["steps"][grad_mode]["state"], one_process["grads"],
                mesh_reference["per_replica"], grad_mode, 2)


@pytest.mark.parametrize("mode", list(MODES))
def test_two_ranks_losses_and_gradients_match_the_jax_mesh(two_ranks, mesh_reference, mode):
    """The global losses (each rank's), the CM weight, and the gradients
    averaged over the ranks, against the JAX step on the 2-device mesh
    (per_replica: with bn_groups=2)."""
    for run in two_ranks:
        _check_losses(run[mode]["losses"], run[mode]["steps"], mesh_reference[mode])
    _check_grads(two_ranks[0][mode]["grads"], mesh_reference[mode], MODES[mode])


@pytest.mark.parametrize("grad_mode", ["per_loss", "legacy_aliased"])
@pytest.mark.parametrize("mode", list(MODES))
def test_two_ranks_step_matches_the_jax_mesh(two_ranks, mesh_reference, mode, grad_mode):
    """Parameters and running stats after the three AdamWs; the two ranks'
    parameters, buffers, losses and gathered probabilities bit-identical."""
    first, second = (r[mode]["steps"][grad_mode] for r in two_ranks)
    _check_step(first["state"], two_ranks[0][mode]["grads"], mesh_reference[mode], grad_mode,
                MODES[mode])
    for k, v in first["state"].items():
        assert np.array_equal(v, second["state"][k]), k
    assert first["losses"] == second["losses"] and first["w"] == second["w"]
    assert first["probs"].shape == (B,) and np.array_equal(first["probs"], second["probs"])


def test_two_ranks_global_probs_are_the_single_programs(two_ranks):
    """The probabilities a rank returns are the whole batch's in its order:
    the one-process step's on the global batch (global mode) within 1e-6."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pmask, "mlm_mask", _port_fixed_mask)
        model = _port_state(1).train()
        with psteps.train_numerics():
            _, _, _, probs, _, _ = psteps.loss_gradients(
                model, decode_batch(dict(_tensors(_batch(False)))), None, True, True, False,
                MARGIN, torch.ones(()))
    np.testing.assert_allclose(two_ranks[0]["global"]["probs"], probs.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["one_process-global", "one_process-per_replica",
                                  "two_ranks-global"])
def test_card_statistics_match_the_jax_mesh(two_ranks, mesh_reference, monkeypatch, case):
    """The numerics of a card, where every BatchNorm accumulates its
    statistics in f64 (``nn/layers.py::_acc_dtype``), forced on the CPU:
    the full-gate losses and gradients in one process (bn_groups 1 and 2)
    and over the two ranks (the global statistics' merge in f64), against
    the JAX step on the mesh, to the f32 step's tolerances."""
    from druglamp_tpu_torch.nn import layers

    where, mode = case.split("-")
    groups = MODES[mode]
    if where == "two_ranks":
        got = two_ranks[0]["global_f64"]
        assert got["losses"] == two_ranks[1]["global_f64"]["losses"]
    else:
        monkeypatch.setattr(layers, "_acc_dtype", lambda x: torch.float64)
        monkeypatch.setattr(pmask, "mlm_mask", _port_fixed_mask)
        model = _port_state(groups).train()
        with psteps.train_numerics():
            *losses, _, _, grads = psteps.loss_gradients(
                model, decode_batch(dict(_tensors(_batch(groups > 1)))), None, True, True,
                False, MARGIN, torch.ones(()))
        names = [n for n, _ in model.named_parameters()]
        got = {"losses": [float(x) for x in losses],
               "grads": {k: {n: g.numpy() for n, g in zip(names, v)} for k, v in grads.items()}}
    ref = mesh_reference[mode]
    assert np.allclose(got["losses"], ref["losses"], rtol=0, atol=1e-5), (got["losses"],
                                                                          ref["losses"])
    _check_grads(got["grads"], ref, groups)


# --- Trainer.fit over two ranks ---------------------------------------------------------------

FIT_SEED = 3


def _fit_spec(d):
    """The toy dataset, a seeded embedding cache and initial weights for the
    rank job ``fit``."""
    root = _toy_dataset(str(d / "data"))
    cfg = _full_port_config(_cfg(epochs=2))
    cache = EmbeddingCache(str(d / "cache"), "toy", ND, NP)
    r = np.random.RandomState(4)
    from druglamp_tpu_torch.data.dataset import DTIDataset

    table = DTIDataset(root, "toy", "random", "train.csv", max_nodes=cfg.drug.max_nodes,
                       seq_len=cfg.protein.seq_len, max_prot_resis=cfg.protein.max_resis).table
    for smi, o in table.drug2ord.items():
        cache.put_drug(o, r.randn(min(len(smi) + 2, cfg.drug.max_nodes), ND))
    for seq, o in table.prot2ord.items():
        cache.put_prot(o, r.randn(min(len(seq), cfg.protein.max_resis) + 2, NP))
    model = port_build_model("DrugLAMP2C2P", cfg, ND, NP,
                             generator=torch.Generator().manual_seed(FIT_SEED))
    return {"cfg": cfg, "nd": ND, "np": NP, "root": root, "cache": str(d / "cache"),
            "patience": 3, "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _read_ranks(d, name, world):
    runs = []
    for rank in range(world):
        with open(d / f"rank{rank}{name}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """One launch of two gloo ranks for both rank jobs: both modes' step
    (``step``) and the fit on both transports with a resume (``fit``); and,
    started alongside, a group of one's fit on the gather transport, the
    reference of either transport (one process's host and gather fits are
    bit-identical: tests/test_torch_port_host_pipeline.py)."""
    d = tmp_path_factory.mktemp("ranks")
    cases = {mode: {"bn_groups": g, "batch": _batch(g > 1),
                    "state": {k: v.clone() for k, v in _port_state(g).state_dict().items()}}
             for mode, g in MODES.items()}
    with open(d / "step.pkl", "wb") as f:
        pickle.dump({"cfg": port_config(tiny_cfg()), "nd": ND, "np": NP, "cases": cases,
                     "lrs": (LR, LR_SSL, LR_CM, MARGIN, CM_W0)}, f)
    spec = _fit_spec(d)
    w1 = d / "world1"
    w1.mkdir()
    for w, transports, resume in ((w1, ["gather"], False), (d, ["gather", "host"], True)):
        with open(w / "fit.pkl", "wb") as f:
            pickle.dump({**spec, "transports": transports, "resume": resume}, f)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        one = pool.submit(run_ranks, RANKS + ["fit", str(w1)], world=1, timeout=600)
        run_ranks(RANKS + ["step,fit", str(d)], timeout=600)
        one.result()
    return {"step": _read_ranks(d, "", 2),
            "fits": {1: (w1, _read_ranks(w1, "_fit", 1)), 2: (d, _read_ranks(d, "_fit", 2))}}


@pytest.fixture(scope="module")
def fits(rank_runs):
    """One rank's fit and two ranks' fits on the same global batches."""
    return rank_runs["fits"]


TIMES = ("t", "epoch_time_s", "pairs_per_s")


@pytest.mark.parametrize("transport", ["gather", "host"])
def test_two_rank_fit_matches_one_rank(fits, transport):
    (w1, (one,)), (w2, two) = fits[1], fits[2]
    got = [r for r in _records(w2 / transport / "metrics.jsonl") if "train_loss" in r]
    ref = [r for r in _records(w1 / "gather" / "metrics.jsonl") if "train_loss" in r]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref] == [1, 2]
    assert "cm_loss" in got[1] and "ssl_loss" in got[1]
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in a:
            if k not in TIMES:
                assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-5), (transport, k)
    for rank in two:
        for k, v in one["gather"]["test"].items():
            assert rank[transport]["test"][k] == pytest.approx(v, rel=1e-5, abs=1e-5), k
        assert rank[transport]["test"] == two[0][transport]["test"]


def test_only_rank_zero_writes_checkpoints(fits):
    _, two = fits[2]
    for transport in ("gather", "host"):
        assert any(p.endswith("ckpt_last.pt.tmp") for p in two[0][transport]["saves"])
        assert two[1][transport]["saves"] == []


def test_two_rank_resume_continues_bit_for_bit(fits):
    """Both ranks, from the epoch-1 checkpoint in a Trainer whose model
    started from other weights, end epoch 2 with the unbroken run's epoch-2
    parameters (its ``ckpt_last.pt``), bit for bit."""
    w, two = fits[2]
    last = torch.load(w / "gather" / "ckpt_last.pt", weights_only=True)["model"]
    for rank in two:
        assert rank["resume"]["epoch"] == 2
        for k, v in last.items():
            assert np.array_equal(rank["resume"]["state"][k], v.numpy()), k


# --- the CLI under two ranks ------------------------------------------------------------------

def test_cli_trains_per_replica_over_two_ranks(tmp_path):
    from tests.test_torch_port_cli import TINY_YAML, _argv

    root = _toy_dataset(str(tmp_path / "data"))
    yaml = os.path.join(root, "tiny.yaml")
    with open(yaml, "w") as f:
        f.write(TINY_YAML)
    work = str(tmp_path / "work")
    outs = run_ranks([sys.executable, "-m", "druglamp_tpu_torch.cli.main"]
                     + _argv(root, yaml, work) + ["--bn-mode", "per_replica", "--devices", "0,1"],
                     timeout=600)
    records = _records(os.path.join(work, "metrics.jsonl"))
    hp = records[0]
    assert hp["ranks"] == 2 and hp["bn_mode"] == "per_replica" and not hp["device_data"]
    epochs = [r for r in records if "train_loss" in r]
    assert [r["epoch"] for r in epochs] == [1, 2] and "cm_loss" in epochs[1]
    test = next(r for r in records if "test_auroc" in r)
    assert all(np.isfinite(v) for r in epochs + [test] for v in r.values()
               if isinstance(v, float))
    assert os.path.exists(os.path.join(work, "ckpt_last.pt"))
    assert "test_auroc" in outs[0][0] and "test_auroc" not in outs[1][0]
