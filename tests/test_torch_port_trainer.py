"""The port's Trainer (druglamp_tpu_torch/train/trainer.py) and what it reads
(data/loader.py, config.py, utils/logging.py) against the JAX package, on the
CPU at fp32 and a tiny DrugLAMP2C2P, over the device-resident transport
(DeviceDataStore + DeviceEmbeddingStore), weights carried over by
``convert.from_jax_params``, dropout 0 and one fixed MLM mask injected into
both packages (every 5th non-pad position, as
``tools/two_framework_train.py`` does).

- The loader's order, host assembly and CM ground truth: bit-identical to
  the JAX loader's, and the device gather gives the loader's batches.
- The YAML recipes load to the same values.
- A 3-epoch fit with init_epoch 2 and epoch_step 2 (cls; ssl + cm +
  calibrate; cm), at LR 1e-5 for the three losses (as
  tests/test_torch_port_device_data.py: an AdamW update turns a gradient
  at rounding-noise level into a ±lr step in either package, so later
  losses drift apart in proportion to lr), early stopping's patience raised
  to 3 in both packages so that all three epochs run: per-epoch losses and
  validation AUSum 1e-5, the CM weight exact, the margin bit-identical, the
  same best epoch; the test metrics on the best state 1e-5.
- The calibrating epoch (make_epoch_step_gather) over 4 steps, LRs at EPOCH_LR,
  per step against the JAX package at the weights the port's step starts
  from: losses, gradients, the CM weight, the parameters after JAX's three
  AdamWs (their states carried) on the port's gradients, running stats;
  and at its end against the JAX package's own compiled epoch, the
  parameters held as tests/test_torch_port_ssl_cm.py holds one step's.  A
  negative control shows the per-step check fails against AdamWs whose
  state is not carried from step to step.
- Resume: a run stopped after epoch 2 and resumed from ``ckpt_last.pt``
  ends bit-identical to the unbroken run, leaf by leaf, dropout and the MLM
  sampler on.
- Slow, out of tier-1: both packages' Trainers on a generated dataset with a
  planted label rule, 10 epochs at ES = IE = 5 in both grad modes, test
  AUROC within 0.005 of each other."""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import druglamp_tpu.models.ssl as jssl
from druglamp_tpu.config import RSConfig as JRSConfig
from druglamp_tpu.config import SolverConfig as JSolverConfig
from druglamp_tpu.config import builtin_config_path as jconfig_path
from druglamp_tpu.config import load_config as jload_config
from druglamp_tpu.data.dataset import DTIDataset as JDataset
from druglamp_tpu.data.device_data import DeviceDataStore as JDataStore
from druglamp_tpu.data.device_store import DeviceEmbeddingStore as JEmbStore
from druglamp_tpu.data.loader import BatchLoader as JBatchLoader
from druglamp_tpu.data.loader import build_cm_arrays as jbuild_cm_arrays
from druglamp_tpu.train import steps as jsteps
from druglamp_tpu.train.state import TrainState as JTrainState
from druglamp_tpu.train.state import apply_optimizer as japply
from druglamp_tpu.train.trainer import Trainer as JTrainer
from druglamp_tpu.utils.logging import ExperimentLogger as JLogger
from druglamp_tpu.utils.synthetic import tiny_config
from druglamp_tpu_torch.config import builtin_config_path, load_config
from druglamp_tpu_torch.convert import to_jax_paths
from druglamp_tpu_torch.data.dataset import DTIDataset
from druglamp_tpu_torch.data.device_data import (DeviceDataStore, gather_compact_batch,
                                                 train_index_plan)
from druglamp_tpu_torch.data.device_store import DeviceEmbeddingStore
from druglamp_tpu_torch.data.loader import BatchLoader, build_cm_arrays
from druglamp_tpu_torch.losses import masking as pmask
from druglamp_tpu_torch.models.registry import build_model as port_build_model
from druglamp_tpu_torch.nn.inits import init_model
from druglamp_tpu_torch.train.state import TrainState
from druglamp_tpu_torch.train.steps import make_epoch_step_gather
from druglamp_tpu_torch.train.trainer import Trainer
from druglamp_tpu_torch.utils.logging import ExperimentLogger
from tests.test_device_data import _RandEmb
from druglamp_tpu_torch.train import steps as psteps
from tests.test_torch_port_ssl_cm import (CM_W0, MARGIN, _assert_params_close, _flat,
                                          _jax_fixed_mask, _jax_loss_grads, _port_fixed_mask)
from tests.torch_port_util import ND, NP, build_pair, port_config

B = 4
SEED = 3
# molecules of 14–30 atoms in 32-node graphs: with a few atoms per graph the
# GCN's BatchNorm channels have a tiny batch variance in train mode, which
# magnifies the last-bit differences of any two f32 implementations
SMILES = ["C" * 20, "CCO" * 8, "c1ccccc1" + "CC" * 8, "CN" * 12, "C1CCCCC1" + "C" * 15,
          "OCC(O)CO" * 3, "CC(C)O" * 5, "c1ccncc1" + "CCO" * 4]
PROTS = ["MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ", "MSEQNNTEMTFQIQRIYTKDIS", "MAHHHHHHVGTGSNG",
         "MWWLKPGTRYAVW"]


LR = 1e-5
# the calibrating epoch's three optimizers: over four steps the weights'
# rounding-noise drift (see LR) moves the losses and the CM head's running
# means by about 1e-5 at 3e-6 each, so 1e-6 keeps the epoch within the
# one-step tolerances
EPOCH_LR = 1e-6


def _cfg(epochs=3, dropout=0.0, init_epoch=2, epoch_step=2, grad_mode="per_loss", lr=LR):
    return tiny_config(n_hidden=16, max_nodes=32, site_seq=16, pmma_dropout=dropout,
                       solver=JSolverConfig(compute_dtype="float32", max_epoch=epochs,
                                            batch_size=B, eval_batch_size=B, ckpt_every=1,
                                            lr=lr, ssl_lr=lr, cm_lr=lr, grad_mode=grad_mode),
                       rs=JRSConfig(ssl=True, cm=True, init_epoch=init_epoch,
                                    epoch_step=epoch_step))


def _write_split(root, name, rows):
    d = os.path.join(root, "toy", "random")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name), "w") as f:
        f.write("\n".join(["SMILES,Protein,Y"] + [f"{s},{p},{y}" for s, p, y in rows]) + "\n")


def _toy_dataset(root, n_train=16, n_eval=10):
    """Pairs of the toy drugs and proteins with seeded labels, half of them 1
    in each split: every train batch of 4 repeats proteins (CM positives,
    negatives, fallback rows)."""
    r = np.random.RandomState(0)
    for name, n in (("train.csv", n_train), ("val.csv", n_eval), ("test.csv", n_eval)):
        labels = r.permutation(np.arange(n) % 2)
        _write_split(root, name, [(SMILES[r.randint(len(SMILES))], PROTS[r.randint(len(PROTS))],
                                   int(y)) for y in labels])
    return root


def _world(root, cfg, build):
    """Datasets, loaders and stores of one package (``build`` gives its
    classes) over the CSVs under ``root``."""
    ds_cls, loader_cls, data_cls, emb_cls, kw_dev = build
    kw = dict(max_nodes=cfg.drug.max_nodes, seq_len=cfg.protein.seq_len,
              max_prot_resis=cfg.protein.max_resis)
    train = ds_cls(root, "toy", "random", "train.csv", **kw)
    val = ds_cls(root, "toy", "random", "val.csv", table=train.table, **kw)
    test = ds_cls(root, "toy", "random", "test.csv", table=train.table, **kw)
    lkw = dict(include_llm=True, emb_ordinals=True, prefetch=0)
    if loader_cls is JBatchLoader:
        lkw["compact"] = True
    loaders = (loader_cls(train, B, shuffle=True, drop_last=True, seed=SEED, **lkw),
               loader_cls(val, B, shuffle=False, drop_last=False, **lkw),
               loader_cls(test, B, shuffle=False, drop_last=False, **lkw))
    emb = emb_cls.build(train.table, _RandEmb(), max_drug_tokens=cfg.drug.max_nodes,
                        max_prot_len=cfg.protein.max_resis + 2, **kw_dev).tree
    data = data_cls.build(train.table, cfg.drug.max_nodes, cfg.protein.seq_len, True, True,
                          **kw_dev)
    return loaders, emb, data


# early stopping's patience for the 3-epoch fits (max_epoch // 4 would stop
# a fit whose validation AUSum does not rise in its second epoch)
PATIENCE = 3

JAX_BUILD = (JDataset, JBatchLoader, JDataStore, JEmbStore, {})
PORT_BUILD = (DTIDataset, BatchLoader, DeviceDataStore, DeviceEmbeddingStore, {"device": "cpu"})


def _full_port_config(cfg):
    """The port's Config with every section of a JAX Config."""
    from druglamp_tpu_torch.config import config_from_dict

    return config_from_dict(dataclasses.asdict(cfg))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# --- loader, CM ground truth, config ----------------------------------------------------

def test_loader_order_and_batches_are_bit_identical(tmp_path):
    """``_order`` and the host assembly equal the JAX loader's; the device
    gather on the same rows gives the loader's batch (tests/test_device_data.py
    holds the JAX package to the same)."""
    cfg = _cfg()
    root = _toy_dataset(str(tmp_path))
    (jl, jvl, _), _, _ = _world(root, cfg, JAX_BUILD)
    (pl, pvl, _), _, data = _world(root, cfg, PORT_BUILD)
    assert len(pl) == len(jl) and len(pvl) == len(jvl) and pl.batch_size == jl.batch_size
    for epoch in range(4):
        np.testing.assert_array_equal(pl._order(epoch), jl._order(epoch))
    np.testing.assert_array_equal(pvl._order(1), jvl._order(1))
    tree = data.tree_for(pl.ds)
    for row in train_index_plan(pl._order(2), B):
        host = pl._assemble_compact(row.astype(np.int64))
        ref = jl._assemble_compact(row.astype(np.int64))
        dev = gather_compact_batch(tree, torch.from_numpy(row), torch.ones(B), True, True,
                                   {"sentinel": torch.zeros(())})
        assert set(host) == set(ref) == set(dev)
        for k in host:
            if k == "cm":
                for ck in host[k]:
                    np.testing.assert_array_equal(host[k][ck], ref[k][ck], err_msg=ck)
                    np.testing.assert_array_equal(dev[k][ck].numpy().astype(host[k][ck].dtype),
                                                  host[k][ck], err_msg=ck)
            else:
                assert host[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(host[k], ref[k], err_msg=k)
                np.testing.assert_array_equal(dev[k].numpy().astype(host[k].dtype), host[k],
                                              err_msg=k)
    first = pl.first_batch(1)
    np.testing.assert_array_equal(first["drug_ord"], jl.first_batch(1)["drug_ord"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_build_cm_arrays_is_bit_identical(seed):
    r = np.random.RandomState(seed)
    pid, did = r.randint(0, 3, 8), r.randint(0, 5, 8)
    labels = r.randint(0, 2, 8).astype(np.float32)
    got, ref = build_cm_arrays(pid, did, labels), jbuild_cm_arrays(pid, did, labels)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name", ["DrugLAMP", "DrugLAMPwoLLM", "DrugLAMP2C2P"])
def test_yaml_recipes_load_like_the_jax_package(name):
    overrides = {"solver.seed": 41, "rs.init_epoch": 3}
    got = load_config(builtin_config_path(name), overrides)
    ref = jload_config(jconfig_path(name), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.rs.ssl and got.rs.cm == (name == "DrugLAMP2C2P")
    with open(builtin_config_path(name)) as f, open(jconfig_path(name)) as g:
        assert f.read() == g.read()


# --- the 3-epoch fit --------------------------------------------------------------------

def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:               # numpy's bfloat16 is ml_dtypes'
        return tree.detach().float().numpy().astype(jnp.bfloat16)
    return tree.detach().numpy().copy()


def _recording(loss_gradients, steps):
    """``loss_gradients`` that also keeps, for each step of the epoch, the
    flat weights and running stats it starts from, its decoded batch, the
    CM weight it is given, its losses, its calibrated weight and its
    gradients (flax paths; the CM gradient times the weight)."""

    def recorded(model, batch, generator, use_ssl, use_cm, calibrate, margin, cm_weight,
                 n_class=1):
        start = {k: v.copy() for k, v in to_jax_paths(model.state_dict(), model).items()}
        cls, ssl, cm, probs, w, grads = loss_gradients(model, batch, generator, use_ssl, use_cm,
                                                       calibrate, margin, cm_weight, n_class)
        names = [n for n, _ in model.named_parameters()]
        steps.append({"start": start, "batch": _numpy_tree(batch),
                      "w_in": np.float32(cm_weight), "w": np.float32(w),
                      "losses": [float(x) for x in (cls, ssl, cm)],
                      "grads": {k: to_jax_paths(dict(zip(names, v)), model)
                                for k, v in grads.items()}})
        return cls, ssl, cm, probs, w, grads

    return recorded


def _tree(flat, keys):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(flat[k]) for k in keys})


def _jax_epoch_steps(jmodel, params, stats, steps, lrs):
    """The JAX package at each step of the port's epoch, from the weights and
    running stats the port's step starts from: its losses, gradients and
    running stats (``_jax_loss_grads``, compiled), the same gradients from
    JAX's op-by-op run of that function (``eager_grads``: the spread of two
    f32 programs of the JAX package), its ``_calibrate`` from the weight the
    step is given; then its three AdamWs applied in order to the port's
    gradients of each step, their states carried from step to step
    (``carried``), and, as a negative control, made anew at every step
    (``reset``)."""
    pkeys, skeys = list(_flat(params)), list(_flat(stats))
    fn = _jax_loss_grads(jmodel, True)
    loss_grads = jax.jit(fn)
    opts = {}
    out = []
    for k, st in enumerate(steps):
        p, s = _tree(st["start"], pkeys), _tree(st["start"], skeys)
        batch = jax.tree.map(jnp.asarray, st["batch"])
        losses, grads, stages = loss_grads(p, s, batch)
        with jax.disable_jit():
            _, eager, _ = fn(p, s, batch)
        cls, ssl, cm = (np.float32(x) for x in losses)
        w = np.float32(jsteps._calibrate(jnp.float32(cm), jnp.float32(cls),
                                         jnp.float32(st["w_in"])))

        def per_loss(g):
            return {"cls": _flat(g[0]), "ssl": _flat(g[1]),
                    "cm": {key: v * w for key, v in _flat(g[2]).items()}}

        rec = {"losses": [float(cls), float(ssl), float(cm * w)], "w": w,
               "grads": per_loss(grads), "eager_grads": per_loss(eager),
               "stats": _flat(stages[2])}
        for mode in ("carried", "reset"):
            if mode not in opts or mode == "reset":
                fresh = JTrainState.create({"params": p, "batch_stats": {}}, True, True)
                opts[mode] = [fresh.opt_cls, fresh.opt_ssl, fresh.opt_cm]
            q = p
            for i, (name, lr) in enumerate(zip(("cls", "ssl", "cm"), lrs)):
                q, opts[mode][i] = japply(opts[mode][i], _tree(st["grads"][name], pkeys), q,
                                          jnp.float32(lr))
            rec[mode] = _flat(q)
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Both Trainers over 3 epochs from the same weights, the mask injected;
    then each package's calibrating epoch driver over the 4 training steps
    from the same weights (JAX's is the one its Trainer compiled)."""
    root = _toy_dataset(str(tmp_path_factory.mktemp("data")))
    work = tmp_path_factory.mktemp("work")
    cfg = _cfg()
    jmodel, params, stats, pmodel = build_pair("DrugLAMP2C2P", cfg)
    (jl, jvl, jtl), jemb, jdata = _world(root, cfg, JAX_BUILD)
    (pl, pvl, ptl), pemb, pdata = _world(root, cfg, PORT_BUILD)
    initial = copy.deepcopy(pmodel)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssl, "mlm_mask", _jax_fixed_mask)
        mp.setattr(pmask, "mlm_mask", _port_fixed_mask)
        mp.setenv("DRUGLAMP_SYNC_CKPT", "1")

        jlog = JLogger(str(work), "jax", quiet=True)
        jt = JTrainer(jmodel, cfg, jl, jvl, jtl, logger=jlog, work_dir=str(work / "jax_run"),
                      embed_store=jemb, device_data=jdata)
        jt.patience = PATIENCE
        jstate = JTrainState.create({"params": jax.tree.map(jnp.array, params),
                                     "batch_stats": jax.tree.map(jnp.array, stats)}, True, True)
        jstate = jt.fit(jstate, SEED)
        out["jax"] = {"records": _records(jlog.jsonl_path), "best_epoch": jt.best_epoch,
                      "test": jt.evaluate(jt._best_state, jtl, full=True)}

        plog = ExperimentLogger(str(work), "port", quiet=True)
        pt = Trainer(pmodel, _full_port_config(cfg), pl, pvl, ptl, logger=plog,
                     work_dir=str(work / "port_run"), embed_store=pemb, device_data=pdata,
                     device="cpu")
        pt.patience = PATIENCE
        test = pt.run_experiment(SEED, state=TrainState.create(pmodel, True, True))
        out["port"] = {"records": _records(plog.jsonl_path), "best_epoch": pt.best_epoch,
                       "test": test}

        # the calibrating epoch's driver, 4 steps, from the initial weights
        idx = train_index_plan(pl._order(2), B)
        ones = np.ones(idx.shape, np.float32)
        lrs = (EPOCH_LR, EPOCH_LR, EPOCH_LR, MARGIN, CM_W0)
        jfn = jt._gather_fns[True, True, True]
        jstate = JTrainState.create({"params": jax.tree.map(jnp.array, params),
                                     "batch_stats": jax.tree.map(jnp.array, stats)}, True, True)
        jo = jfn(jstate, jnp.asarray(idx), jnp.asarray(ones), jdata.tree_for(jl.ds), jemb,
                 jax.random.key(0), *map(jnp.float32, lrs))
        out["jax"]["epoch"] = (
            [np.asarray(x) for x in (jo.cls_losses, jo.ssl_losses, jo.cm_losses)],
            np.float32(jo.cm_weight),
            {"/".join(k): np.asarray(v) for k, v in
             traverse_util.flatten_dict({"params": jo.state.params,
                                         "stats": jo.state.batch_stats}).items()})
        model = initial
        fn = make_epoch_step_gather(model, True, True, True, True, calibrate=True, device="cpu")
        steps = []
        mp.setattr(psteps, "loss_gradients", _recording(psteps.loss_gradients, steps))
        po = fn(TrainState.create(model, True, True), idx, ones, pdata.tree_for(pl.ds), pemb,
                torch.Generator().manual_seed(0), *lrs)
        out["port"]["epoch"] = ([x.numpy() for x in (po.cls_losses, po.ssl_losses,
                                                     po.cm_losses)],
                                np.float32(po.cm_weight), to_jax_paths(model.state_dict(), model))
        out["port"]["steps"] = steps
        out["jax"]["steps"] = _jax_epoch_steps(jmodel, params, stats, steps, lrs)
    return out


def test_fit_per_epoch_matches_jax(fits):
    """Epoch 1 cls only, epoch 2 ssl + cm with the calibration, epoch 3 cm:
    losses, validation AUROC/AUPRC/AUSum and loss 1e-5, the LRs, the CM weight
    and the margin equal, and the same best epoch."""
    ref = [r for r in fits["jax"]["records"] if "epoch" in r and "train_loss" in r]
    got = [r for r in fits["port"]["records"] if "epoch" in r and "train_loss" in r]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref] == [1, 2, 3]
    assert "ssl_loss" not in got[0] and "cm_loss" not in got[0]
    assert "ssl_loss" in got[1] and "cm_loss" in got[1] and "ssl_loss" not in got[2]
    for g, r in zip(got, ref):
        assert set(g) == set(r), (set(g) ^ set(r))
        for k in r:
            if k in ("t", "epoch_time_s", "pairs_per_s"):
                continue
            if k in ("epoch", "lr", "margin", "cm_weight"):
                assert g[k] == r[k], (r["epoch"], k, g[k], r[k])
            else:
                assert abs(g[k] - r[k]) <= 1e-5, (r["epoch"], k, g[k], r[k])
    assert fits["port"]["best_epoch"] == fits["jax"]["best_epoch"]


def test_test_metrics_on_the_best_state_match_jax(fits):
    got, ref = fits["port"]["test"], fits["jax"]["test"]
    assert set(got) == set(ref)
    for k in ("auroc", "auprc", "ausum", "loss"):
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])


def test_calibrating_epoch_matches_jax(fits):
    """The port's calibrating epoch against the JAX package's compiled one
    from the same weights: per-step losses 1e-5, the last CM weight exact,
    the running stats 1e-5, the parameters as
    ``test_step_parameters_and_stats_match_jax`` holds one step's: rtol 1e-5
    / atol 1e-7 where, at every step, each gradient of the port and of the
    JAX package (at the port's weights) gives the same AdamW direction to
    1e-4, else within the LRs' reach (2·Σlr), on at most MAX_NOISY of the
    entries."""
    (jl, jw, jstate), (pl, pw, pstate) = fits["jax"]["epoch"], fits["port"]["epoch"]
    for name, a, b in zip(("cls", "ssl", "cm"), pl, jl):
        assert a.shape == b.shape == (4,)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
    assert pw == jw
    want = {}
    for key, ref in jstate.items():
        kind, path = key.split("/", 1)
        if kind == "stats":
            np.testing.assert_allclose(pstate[path], ref, rtol=0, atol=1e-5, err_msg=path)
        else:
            want[path] = ref
    losses = ("cls", "ssl", "cm")
    applied = [(EPOCH_LR, jr["grads"][loss]) for jr in fits["jax"]["steps"] for loss in losses]
    other = [(EPOCH_LR, st["grads"][loss]) for st in fits["port"]["steps"] for loss in losses]
    _assert_params_close({k: pstate[k] for k in want}, want, applied, 1e-5, 1e-7, "epoch",
                         other)


def _step_ends(fits):
    """The port's flat weights and running stats after each epoch step."""
    return [st["start"] for st in fits["port"]["steps"][1:]] + [fits["port"]["epoch"][2]]


def test_calibrating_epoch_per_step_matches_jax(fits):
    """Each of the epoch's 4 steps against the JAX package at the weights and
    running stats the port's step starts from: the losses 1e-5, each loss's
    gradient rtol 5e-3 / atol 5e-5 (an entry outside that no farther from
    JAX's compiled gradient than JAX's own op-by-op run comes in the same
    leaf: where BatchNorm divides by a small batch variance, two f32
    programs of the JAX package differ beyond it), the CM weight exact (JAX's ``_calibrate``
    from the weight the previous step left), the parameters after the three
    AdamWs rtol 1e-5 / atol 1e-7 against JAX's AdamWs applied to the port's
    gradients with their states carried from step to step, the running stats
    1e-5."""
    steps, ref = fits["port"]["steps"], fits["jax"]["steps"]
    assert len(steps) == len(ref) == 4
    w_prev = np.float32(CM_W0)
    for k, (st, jr, end) in enumerate(zip(steps, ref, _step_ends(fits))):
        assert st["w_in"] == w_prev and st["w"] == jr["w"], (k, st["w_in"], st["w"], jr["w"])
        w_prev = st["w"]
        for name, a, b in zip(("cls", "ssl", "cm"), st["losses"], jr["losses"]):
            assert abs(a - b) <= 1e-5, (k, name, a, b)
        for loss, want in jr["grads"].items():
            assert set(st["grads"][loss]) == set(want)
            for key, v in want.items():
                diff = np.abs(st["grads"][loss][key] - v)
                off = diff > 5e-5 + 5e-3 * np.abs(v)
                spread = np.abs(jr["eager_grads"][loss][key] - v).max()
                assert np.all(diff[off] <= spread), (k, loss, key, diff[off], spread)
        for key, v in jr["carried"].items():
            np.testing.assert_allclose(end[key], v, rtol=1e-5, atol=1e-7, err_msg=f"step {k} {key}")
        for key, v in jr["stats"].items():
            np.testing.assert_allclose(end[key], v, rtol=0, atol=1e-5, err_msg=f"step {k} {key}")


def test_calibrating_epoch_rejects_reset_optimizers(fits):
    """Negative control: the per-step parameter check above fails against
    AdamWs whose moments and step count start anew at every step, so it
    sees an optimizer state that is not carried across steps."""
    off = total = 0
    for k, (jr, end) in enumerate(zip(fits["jax"]["steps"], _step_ends(fits))):
        if k == 0:
            continue
        for key, v in jr["reset"].items():
            off += int((np.abs(end[key] - v) > 1e-7 + 1e-5 * np.abs(v)).sum())
            total += v.size
    assert off > 0.1 * total, (off, total)


# --- resume ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def test_resume_is_bit_identical(tmp_path):
    """An unbroken 3-epoch run against one stopped in epoch 3 and resumed from
    its epoch-2 ``ckpt_last.pt`` by a Trainer whose model starts from other
    weights: the final checkpoints are equal leaf by leaf (model, the three
    optimizers, host state), and so are the test metrics."""
    cfg = _cfg(dropout=0.1, lr=1e-4)
    root = _toy_dataset(str(tmp_path / "data"))
    pcfg = _full_port_config(cfg)
    (pl, pvl, ptl), pemb, pdata = _world(root, cfg, PORT_BUILD)

    def trainer(work, seed):
        model = port_build_model("DrugLAMP2C2P", port_config(cfg), ND, NP)
        init_model(model, torch.Generator().manual_seed(seed))
        t = Trainer(model, pcfg, pl, pvl, ptl, work_dir=str(tmp_path / work), embed_store=pemb,
                    device_data=pdata, device="cpu")
        t.patience = PATIENCE
        return t, TrainState.create(model, True, True)

    full, state = trainer("full", 0)
    metrics_full = full.run_experiment(SEED, state=state)
    broken, state = trainer("broken", 0)
    run_epoch = broken._fit_epoch_gather

    def stop_in_epoch_3(state, epoch, *args):
        if epoch == 3:
            raise _Stop
        return run_epoch(state, epoch, *args)

    broken._fit_epoch_gather = stop_in_epoch_3
    with pytest.raises(_Stop):
        broken.run_experiment(SEED, state=state)
    resumed, state = trainer("broken", 1)
    metrics_resumed = resumed.run_experiment(SEED, resume=True, state=state)
    assert resumed.epoch == 3 and resumed.cm_weight == full.cm_weight
    assert metrics_resumed == metrics_full

    a = torch.load(tmp_path / "full" / "ckpt_last.pt", weights_only=True)
    b = torch.load(tmp_path / "broken" / "ckpt_last.pt", weights_only=True)
    assert a["host"] == b["host"] and a["host"]["epoch"] == 3

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert set(la) == set(lb)
    assert any(k.startswith("/optim/opt_ssl/state/") for k in la)
    assert any(k.startswith("/optim/opt_cm/state/") for k in la)
    for k, v in la.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, lb[k]), k
        else:
            assert v == lb[k], k


# --- the two-framework run (slow) ---------------------------------------------------------

AROMATIC = ["c1ccccc1", "c1ccncc1", "Cc1ccccc1", "Oc1ccccc1", "c1ccc2ccccc2c1", "Nc1ccccc1",
            "CCc1ccccc1", "Clc1ccccc1"]
ALIPHATIC = ["CCO", "CCN", "CC(=O)O", "C1CCCCC1", "CC(C)O", "OCC(O)CO", "CCCCN", "CC(C)(C)O"]


def _planted_dataset(root, seed=0, n=(384, 96, 128), noise=0.1):
    """Pairs whose label is planted: 1 iff the drug is aromatic and the
    protein carries a tryptophan motif (WW), flipped for a ``noise`` share of
    the pairs (so validation AUSum does not saturate in the first epochs);
    proteins are seeded random sequences, half with the motif."""
    r = np.random.RandomState(seed)
    amino = "ACDEFGHIKLMNPQRSTVY"
    prots = []
    for i in range(12):
        seq = "".join(amino[j] for j in r.randint(0, len(amino), r.randint(20, 40)))
        if i % 2 == 0:
            k = r.randint(1, len(seq) - 2)
            seq = seq[:k] + "WW" + seq[k:]
        prots.append(seq)
    drugs = AROMATIC + ALIPHATIC
    for name, count in zip(("train.csv", "val.csv", "test.csv"), n):
        rows = []
        for _ in range(count):
            d, p = drugs[r.randint(len(drugs))], prots[r.randint(len(prots))]
            rows.append((d, p, int((d in AROMATIC and "WW" in p) != (r.rand() < noise))))
        _write_split(root, name, rows)
    return root


@pytest.mark.slow
@pytest.mark.parametrize("grad_mode", ["per_loss", "legacy_aliased"])
def test_two_framework_ssl_cm_auroc(tmp_path, grad_mode):
    """DrugLAMP2C2P, small widths, the recipe's LRs (1e-4, 3e-5, 3e-5) and
    ES = IE = 5 over all 10 epochs (no early stop, so the gated epochs 5–10
    compete for the best state), the mask injected: each package's Trainer
    from the same weights on the planted-rule data, test AUROC on its best
    state within 0.005, and the rule learned (AUROC above 0.75)."""
    base = _cfg(epochs=10, init_epoch=5, epoch_step=5, grad_mode=grad_mode)
    cfg = dataclasses.replace(base, solver=dataclasses.replace(
        base.solver, batch_size=8, eval_batch_size=8, lr=1e-4, ssl_lr=3e-5, cm_lr=3e-5))
    root = _planted_dataset(str(tmp_path / "data"))
    jmodel, params, stats, pmodel = build_pair("DrugLAMP2C2P", cfg, seed=1)
    global B
    saved_b, B = B, 8
    try:
        (jl, jvl, jtl), jemb, jdata = _world(root, cfg, JAX_BUILD)
        (pl, pvl, ptl), pemb, pdata = _world(root, cfg, PORT_BUILD)
    finally:
        B = saved_b
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssl, "mlm_mask", _jax_fixed_mask)
        mp.setattr(pmask, "mlm_mask", _port_fixed_mask)
        mp.setenv("DRUGLAMP_SYNC_CKPT", "1")
        jlog = JLogger(str(tmp_path), "jax", quiet=True)
        jt = JTrainer(jmodel, cfg, jl, jvl, jtl, logger=jlog, work_dir=str(tmp_path / "jax"),
                      embed_store=jemb, device_data=jdata)
        jt.patience = 10
        jstate = JTrainState.create({"params": jax.tree.map(jnp.array, params),
                                     "batch_stats": jax.tree.map(jnp.array, stats)}, True, True)
        jt.fit(jstate, SEED)
        ref = jt.evaluate(jt._best_state, jtl, full=True)
        plog = ExperimentLogger(str(tmp_path), "port", quiet=True)
        pt = Trainer(pmodel, _full_port_config(cfg), pl, pvl, ptl, logger=plog,
                     work_dir=str(tmp_path / "port"), embed_store=pemb, device_data=pdata,
                     device="cpu")
        pt.patience = 10
        got = pt.run_experiment(SEED, state=TrainState.create(pmodel, True, True))
    val = [[round(r["val_auroc"], 4) for r in _records(log.jsonl_path) if "val_auroc" in r]
           for log in (plog, jlog)]
    print(f"two-framework {grad_mode}: test AUROC port {got['auroc']:.4f} jax "
          f"{ref['auroc']:.4f} (best epochs {pt.best_epoch} / {jt.best_epoch}); validation "
          f"AUROC by epoch, port {val[0]}, jax {val[1]}")
    assert min(got["auroc"], ref["auroc"]) > 0.75, (got["auroc"], ref["auroc"])
    assert abs(got["auroc"] - ref["auroc"]) <= 0.005, (got["auroc"], ref["auroc"])


def test_trainer_runs_on_the_card_unless_asked(tmp_path):
    """The Trainer's device is ``cuda`` unless the caller asks for the CPU: on
    a machine without a card it raises instead of training on the CPU, over
    either transport; without the device-resident dataset it takes the host
    pipeline, one step call per batch whatever ``solver.scan_chunk`` says."""
    cfg = _full_port_config(_cfg())
    model = port_build_model("DrugLAMP2C2P", port_config(_cfg()), ND, NP)
    if not torch.cuda.is_available():
        for data in (object(), None):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Trainer(model, cfg, None, None, None, work_dir=str(tmp_path), device_data=data)
    for chunk in (64, 0):
        c = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, scan_chunk=chunk))
        assert Trainer(model, c, None, None, None, work_dir=str(tmp_path),
                       device="cpu").transport == "host"
