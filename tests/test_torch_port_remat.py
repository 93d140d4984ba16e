"""``DRUGLAMP_REMAT`` in the port (``druglamp_tpu_torch/train/remat.py``) on
the CPU, at a tiny configuration.

- Every mode is the eager step bit for bit: for ``dots`` and ``full``, every
  gate combination (cls; cls + ssl; cls + ssl + cm with the calibration)
  and both grad modes, the step's losses, probabilities, CM weight,
  parameters, BatchNorm buffers, AdamW moments and the generator's state
  after it are ``torch.equal`` to ``none``'s, with dropout on and the MLM
  mask drawn from the step's generator (so each recompute must rewind it);
  likewise every variant (DrugLAMP, DrugLAMPwoLLM, ``linattn`` PMMA), a
  4-step ``make_epoch_step_gather`` epoch, the CLI over the host pipeline
  and over the device-resident dataset (the ``Trainer``'s two paths), and
  one step on each of two gloo ranks, as data ranks with global BatchNorm
  and as one model axis (``tests/torch_port_ranks.py::job_remat``).
- The port's ``full`` step against the JAX package's step under
  ``DRUGLAMP_REMAT=full`` (``druglamp_tpu/train/steps.py::_make_step_body``,
  one compile), on the same weights (the port's, perturbed, carried over by
  ``convert.to_jax_paths``) and the fixed MLM mask of the parity tests,
  dropout 0, f32: the three losses
  within 1e-5, each loss's gradient (read from its AdamW's first moment,
  (1 − β1)·g after one step) within rtol 5e-3 / atol 5e-5.
- ``DRUGLAMP_REMAT=bogus`` raises ``ValueError``, as the JAX package's
  ``_remat_wrap`` does.
- What the graph keeps, and that nothing a recompute rebuilt outlives its
  gradient: ``test_the_graph_keeps_less_and_no_recompute_outlives_its_gradient``.
"""

import collections
import copy
import functools
import os
import pickle
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint as torch_checkpoint
from flax import traverse_util

import druglamp_tpu.models.ssl as jssl
from druglamp_tpu.models.registry import build_model as jax_build_model
from druglamp_tpu.train import steps as jsteps
from druglamp_tpu.train.state import TrainState as JTrainState
from druglamp_tpu_torch.cli import main as cli
from druglamp_tpu_torch.convert import to_jax_paths
from druglamp_tpu_torch.data.device_data import train_index_plan
from druglamp_tpu_torch.data.encoding import compact_batch, decode_batch
from druglamp_tpu_torch.data.loader import build_cm_arrays
from druglamp_tpu_torch.losses import masking as pmask
from druglamp_tpu_torch.models.registry import build_model
from druglamp_tpu_torch.nn.mhla import MultiHeadLinearAttention
from druglamp_tpu_torch.train import remat
from druglamp_tpu_torch.train import steps
from druglamp_tpu_torch.train.state import TrainState
from druglamp_tpu_torch.utils.synthetic import make_batch, tiny_config
from tests.test_torch_port_cli import CASES, TINY_YAML, _argv, _seed_cache, _strip
from tests.test_torch_port_ssl_cm import _jax_fixed_mask, _step_batch
from tests.test_torch_port_trainer import PORT_BUILD, _cfg, _records, _toy_dataset, _world
from tests.torch_port_ranks import fixed_mask as _port_fixed_mask
from tests.torch_port_ranks import run_ranks
from tests.torch_port_util import ND, NP, port_config, tiny_cfg, to_torch

torch.set_num_threads(1)

LRS = (1e-3, 1e-3, 1e-3, 0.5, 1e-3)      # lr_cls, lr_ssl, lr_cm, margin, the CM weight
GATES = {"cls": (False, False, False), "cls_ssl": (True, False, False),
         "cls_ssl_cm": (True, True, True)}
B = 6


def _port_batch(cfg, seed=3):
    """A compact batch of B with CM ground truth (positives, negatives and a
    fallback protein)."""
    host = make_batch(cfg, B, seed=seed, n_drug_feature=ND, n_prot_feature=NP)
    batch = compact_batch(host, (host["d_fill"] == 0).sum(1))
    t = np.arange(B)
    pid, did = t % 3, t % 4
    batch["labels"] = ((t % 2 == 0) & (pid != 2)).astype(np.float32)
    batch["cm"] = build_cm_arrays(pid, did, batch["labels"])
    return batch


@functools.lru_cache(maxsize=None)
def _base(name="DrugLAMP2C2P", variant="pmma"):
    """A seeded tiny model, dropout 0.1 in PMMA and the MHLA."""
    cfg = tiny_config(n_hidden=16, max_nodes=32, site_seq=16, pmma_dropout=0.1)
    model = build_model(name, cfg, ND, NP, generator=torch.Generator().manual_seed(0),
                        pmma_variant=variant)
    for m in model.modules():        # the MHLA's dropout too (0 in the recipe)
        if isinstance(m, MultiHeadLinearAttention):
            m.dropout_rate = 0.1
    return cfg, model


def _snapshot(model, state, outs, gen):
    """What two steps from one start must share: each step's outputs, the
    model's state, every AdamW moment, the generator's state."""
    moments = [v.clone() for opt in (state.opt_cls, state.opt_ssl, state.opt_cm) if opt
               for p in model.parameters() for v in opt.state[p].values()]
    return ([[o.cls_loss, o.ssl_loss, o.cm_loss, o.probs, o.cm_weight] for o in outs],
            {k: v.clone() for k, v in model.state_dict().items()}, moments, gen.get_state())


def _assert_equal(got, want):
    (og, sg, mg, gg), (ow, sw, mw, gw) = got, want
    for a, b in zip(og, ow):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), (a, b)
    assert sg.keys() == sw.keys()
    assert [k for k in sw if not torch.equal(sg[k], sw[k])] == []
    assert len(mg) == len(mw) and all(torch.equal(x, y) for x, y in zip(mg, mw))
    assert torch.equal(gg, gw)


class _Frames:
    """Every ``torch.utils.checkpoint`` frame (``_CheckpointFrame``, torch's
    record of one region) made while it is on, and a weak reference to each
    tensor a recompute rebuilt: a frame keeps those in ``recomputed[graph
    task]`` until the backward unpacks them, here a map that also notes
    each one as it is put in."""

    def __init__(self, monkeypatch):
        self.frames = weakref.WeakSet()
        self.rebuilt = []
        self.made = 0
        frames, rebuilt = self.frames, self.rebuilt

        class Noting(weakref.WeakKeyDictionary):
            def __setitem__(self, key, value):
                rebuilt.append(weakref.ref(value))
                super().__setitem__(key, value)

        cls = torch_checkpoint._CheckpointFrame
        init = cls.__init__

        def record(frame, *a, **k):
            init(frame, *a, **k)
            frame.recomputed = collections.defaultdict(Noting)
            frames.add(frame)
            self.made += 1

        monkeypatch.setattr(cls, "__init__", record)

    def held(self, kept):
        """Rebuilt tensors still alive, those over memory of ``kept`` (what the
        graph holds anyway: a region's input comes back as itself) aside."""
        ptrs = {t.untyped_storage().data_ptr() for t in kept}
        alive = [r() for r in self.rebuilt]
        return sum(t is not None and t.untyped_storage().data_ptr() not in ptrs for t in alive)


def _steps(monkeypatch, mode, gate, grad_mode="per_loss", name="DrugLAMP2C2P", variant="pmma",
           n=2):
    """``n`` steps of a fresh copy of the seeded model under ``mode``; every
    region checkpointed and recomputed under dots and full, none under none."""
    monkeypatch.setenv("DRUGLAMP_REMAT", mode)
    frames = _Frames(monkeypatch)
    cfg, base = _base(name, variant)
    model = copy.deepcopy(base)
    use_ssl, use_cm, calibrate = GATES[gate]
    state = TrainState.create(model, use_ssl, use_cm, flat_opt=False)
    step = steps.make_train_step(model, use_ssl, use_cm, calibrate=calibrate,
                                 grad_mode=grad_mode, device="cpu")
    gen = torch.Generator().manual_seed(5)
    batch = _port_batch(cfg)
    outs = [step(state, batch, gen, *LRS) for _ in range(n)]
    assert (frames.made > 0 and len(frames.rebuilt) > 0) == (mode != "none")
    return _snapshot(model, state, outs, gen)


_NONE = {}


def _none(monkeypatch, *key):
    if key not in _NONE:
        _NONE[key] = _steps(monkeypatch, "none", *key)
    return _NONE[key]


@pytest.mark.parametrize("grad_mode", steps.GRAD_MODES)
@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("mode", ["dots", "full"])
def test_remat_step_is_the_eager_step(monkeypatch, mode, gate, grad_mode):
    _assert_equal(_steps(monkeypatch, mode, gate, grad_mode),
                  _none(monkeypatch, gate, grad_mode))


@pytest.mark.parametrize("name,variant,gate", [("DrugLAMP", "pmma", "cls_ssl"),
                                               ("DrugLAMPwoLLM", "pmma", "cls_ssl"),
                                               ("DrugLAMP2C2P", "linattn", "cls_ssl_cm")])
@pytest.mark.parametrize("mode", ["dots", "full"])
def test_every_variant(monkeypatch, mode, name, variant, gate):
    _assert_equal(_steps(monkeypatch, mode, gate, name=name, variant=variant),
                  _none(monkeypatch, gate, "per_loss", name, variant))


def test_bad_mode_raises(monkeypatch):
    monkeypatch.setenv("DRUGLAMP_REMAT", "bogus")
    with pytest.raises(ValueError, match="none|dots|full"):
        steps.make_train_step(copy.deepcopy(_base()[1]), False, False, device="cpu")
    with pytest.raises(ValueError):
        remat.mode()


@pytest.mark.parametrize("value,want", [(None, "none"), ("", "none"), ("0", "none"),
                                        ("NONE", "none"), ("Dots", "dots"), ("full", "full")])
def test_mode_reads_the_variable_as_the_jax_package_does(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("DRUGLAMP_REMAT", raising=False)
    else:
        monkeypatch.setenv("DRUGLAMP_REMAT", value)
    assert remat.mode() == want


def test_regions_are_gone_after_the_step(monkeypatch):
    """The regions exist only while the step's forward runs: after a full
    step every region's call is its class's own again."""
    monkeypatch.setenv("DRUGLAMP_REMAT", "full")
    cfg, base = _base()
    model = copy.deepcopy(base)
    step = steps.make_train_step(model, True, True, calibrate=True, device="cpu")
    step(TrainState.create(model, True, True, flat_opt=False), _port_batch(cfg),
         torch.Generator().manual_seed(1), *LRS)
    targets = list(remat._targets(model))
    assert len(targets) == 3 + 1 + 4 + 4 + 1 + 4 + 1
    for obj, name in targets:
        assert name not in vars(obj), name


# --- what the graph keeps ---------------------------------------------------------------------

def _storage_bytes(tensors):
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def _graph_bytes(monkeypatch, mode):
    """(bytes the graph holds when the first gradient starts, [rebuilt
    tensors still alive after each gradient], tensors rebuilt, checkpoint
    frames still alive after the call) of one full-gate ``loss_gradients``
    under ``mode``."""
    cfg, base = _base()
    model = copy.deepcopy(base).train()
    batch = decode_batch(steps.to_device(_port_batch(cfg), torch.device("cpu")))
    saved, held, made = [], [], []
    frames = _Frames(monkeypatch)
    grad = torch.autograd.grad
    make = remat.Regions

    def regions(*a):
        r = make(*a)
        made.append(r)
        return r

    def first_grad(*a, **k):
        if held:      # what the last gradient left
            held.append(frames.held(saved))
        else:
            kept = [v.get_val(True) if hasattr(v, "get_val") else v
                    for r in made for s in r._storages for e in s.values()
                    for v in (e.values() if isinstance(e, dict) else e)
                    if hasattr(v, "get_val") or isinstance(v, torch.Tensor)]
            held.append(_storage_bytes(saved + kept))
        return grad(*a, **k)

    def pack(t):
        saved.append(t.detach())      # as itself, a saved output would hold its own node
        return saved[-1]

    with monkeypatch.context() as m:
        m.setattr(remat, "Regions", regions)
        m.setattr(torch.autograd, "grad", first_grad)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = steps.loss_gradients(model, batch, torch.Generator().manual_seed(5), True, True,
                                       True, 0.5, torch.ones(()), remat_mode=mode)
    held.append(frames.held(saved))
    assert all(torch.isfinite(v).all() for v in out[:3])
    n_rebuilt = len(frames.rebuilt)
    del out, saved, made
    return held[0], held[1:], n_rebuilt, len(frames.frames)


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_the_graph_keeps_less_and_no_recompute_outlives_its_gradient(monkeypatch, mode):
    """The bytes the graph holds between the forward and the first gradient of
    the full-gate ``loss_gradients``, counted on the CPU by saved-tensor hooks
    (``torch.autograd.graph.saved_tensors_hooks`` around the forward: each
    tensor autograd saves outside a region, and each region's inputs, the
    distinct storages summed; inside a region the checkpoint's own hooks
    take over) plus, under ``dots``, the products each region's selective
    checkpoint keeps: lower under ``dots`` and ``full`` than under ``none``.
    After each of the three gradients no tensor a recompute rebuilt is
    alive (weak references to each, ``_Frames``), and once the call returns
    no checkpoint frame is (a selective checkpoint's saved outputs, handed
    to autograd as they were, kept the previous gradient's recomputed
    graph, and the regions' frames past the step: ``remat._aliased``)."""
    eager, after, rebuilt, _ = _graph_bytes(monkeypatch, "none")
    assert after == [0, 0, 0] and rebuilt == 0
    kept, after, rebuilt, frames = _graph_bytes(monkeypatch, mode)
    assert rebuilt > 0 and after == [0, 0, 0], after
    assert frames == 0, frames        # nothing of the step outlives it
    assert kept < eager, (kept, eager)


# --- the other entry points --------------------------------------------------------------------------

def test_gather_epoch(monkeypatch, tmp_path):
    """A 4-step ``make_epoch_step_gather`` epoch (ssl, cm, calibrate, dropout
    on) over the device-resident toy dataset under full equals none."""
    cfg = _cfg(dropout=0.1)
    (pl, _, _), emb, data = _world(_toy_dataset(str(tmp_path)), cfg, PORT_BUILD)
    tree = data.tree_for(pl.ds)
    idx = train_index_plan(np.random.RandomState(0).permutation(len(pl.ds)), 4)[:4]
    ones = np.ones(idx.shape, np.float32)
    runs, frames = {}, _Frames(monkeypatch)
    for mode in ("none", "full"):
        monkeypatch.setenv("DRUGLAMP_REMAT", mode)
        model = build_model("DrugLAMP2C2P", tiny_config(n_hidden=16, max_nodes=32, site_seq=16),
                            ND, NP, generator=torch.Generator().manual_seed(0))
        state = TrainState.create(model, True, True, flat_opt=False)
        epoch = steps.make_epoch_step_gather(model, True, True, True, True, calibrate=True,
                                             device="cpu")
        gen = torch.Generator().manual_seed(3)
        out = epoch(state, idx, ones, tree, emb, gen, *LRS)
        runs[mode] = ([out.cls_losses, out.ssl_losses, out.cm_losses, out.cm_weight],
                      model.state_dict(), gen.get_state(), frames.made)
    (la, sa, ga, n_none), (lb, sb, gb, n_full) = runs["none"], runs["full"]
    assert n_none == 0 and n_full > 0
    assert idx.shape == (4, 4)
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert [k for k in sa if not torch.equal(sa[k], sb[k])] == []
    assert torch.equal(ga, gb)


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = _toy_dataset(str(tmp_path_factory.mktemp("data")))
    with open(os.path.join(root, "tiny.yaml"), "w") as f:
        f.write(TINY_YAML)
    return root


@pytest.mark.parametrize("case", ["off", "auto"])
def test_cli_and_trainer(monkeypatch, tmp_path, cli_root, case):
    """The training CLI (the ``Trainer`` over host batches, ``--device-data
    off``, and over the device-resident dataset, ``auto``; dropout 0.1, the
    recipe's gates) under full writes none's records, times aside."""
    from druglamp_tpu_torch.data.dataset import DTIDataset

    records, frames, made = {}, _Frames(monkeypatch), {}
    for mode in ("none", "full"):
        monkeypatch.setenv("DRUGLAMP_REMAT", mode)
        wd = str(tmp_path / mode)
        table = DTIDataset(cli_root, "toy", "random", "train.csv", max_nodes=32, seq_len=144,
                           max_prot_resis=40).table
        _seed_cache(os.path.join(wd, "embed_cache"), table)
        assert cli.main(_argv(cli_root, os.path.join(cli_root, "tiny.yaml"), wd)
                        + CASES[case]) == 0
        records[mode] = _strip(_records(os.path.join(wd, "metrics.jsonl")))
        made[mode] = frames.made
    assert made["none"] == 0 and made["full"] > 0
    assert records["full"] == records["none"] and len(records["none"]) > 2


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    outs = run_ranks([sys.executable, "-m", "tests.torch_port_ranks", "remat", str(d)],
                     timeout=240)
    assert len(outs) == 2
    res = []
    for r in range(2):
        with open(d / f"rank{r}_remat.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.mark.parametrize("axis", ["data", "model"])
def test_two_ranks(two_ranks, axis):
    """One full-gate step under full on each of two gloo ranks equals none's
    there, and the ranks agree on the losses: as data ranks (global
    BatchNorm, the CM and MLM collectives run again in the recomputes)
    and as one model axis (the row-parallel products' all-reduces run
    again in the recomputes)."""
    res = [r[axis] for r in two_ranks]
    for r in res:
        assert r["differ"] == [], r["differ"]
        assert r["recomputed"] > 0
    assert res[0]["losses"] == res[1]["losses"]


# --- against the JAX package -------------------------------------------------------------------

def _mu(opt_state):
    """The first moment of an optax AdamW state, a params tree."""
    (adam,) = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
               if hasattr(s, "mu")]
    return adam.mu


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


def _perturbed(cfg):
    """The port's seeded DrugLAMP2C2P at ``cfg`` with seeded noise on every
    parameter and random BatchNorm running stats, and the same weights as the
    JAX package's trees (``convert.to_jax_paths``)."""
    model = build_model("DrugLAMP2C2P", port_config(cfg), ND, NP,
                        generator=torch.Generator().manual_seed(0))
    r = np.random.RandomState(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(0.05 * r.randn(*p.shape).astype(np.float32)))
        for name, b in model.named_buffers():
            b.copy_(torch.from_numpy((r.uniform(0.5, 2.0, b.shape) if name.endswith("var")
                                      else 0.5 * r.randn(*b.shape)).astype(np.float32)))
    flat = to_jax_paths(model.state_dict(), model)
    stats = {k for k in flat if k.rsplit("/", 1)[-1] in ("mean", "var")}

    def tree(keys):
        return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(flat[k])
                                             for k in keys})

    return model, tree(set(flat) - stats), tree(stats)


def test_full_step_matches_the_jax_full_step(monkeypatch):
    monkeypatch.setenv("DRUGLAMP_REMAT", "full")
    monkeypatch.setattr(jssl, "mlm_mask", _jax_fixed_mask)
    monkeypatch.setattr(pmask, "mlm_mask", _port_fixed_mask)
    cfg = tiny_cfg()
    model, params, stats = _perturbed(cfg)
    batch = _step_batch(cfg)
    body = jsteps._make_step_body(jax_build_model("DrugLAMP2C2P", cfg, ND, NP), True, True, True,
                                  "per_loss", 1)
    jstate = JTrainState.create({"params": params, "batch_stats": stats}, True, True)
    jout = jax.jit(body)(jstate, jax.tree.map(jnp.asarray, batch), jax.random.key(2),
                         *map(jnp.float32, LRS))

    state = TrainState.create(model, True, True, flat_opt=False)
    tbatch = to_torch({k: v for k, v in batch.items() if k != "cm"})
    tbatch["cm"] = to_torch(batch["cm"])
    out = steps.make_train_step(model, True, True, calibrate=True, device="cpu")(
        state, tbatch, None, *LRS)
    for got, want in zip((out.cls_loss, out.ssl_loss, out.cm_loss),
                         (jout.cls_loss, jout.ssl_loss, jout.cm_loss)):
        assert abs(float(got) - float(want)) <= 1e-5
    assert float(out.cm_weight) == float(jout.cm_weight)
    names = [n for n, _ in model.named_parameters()]
    for opt, jopt in ((state.opt_cls, jout.state.opt_cls), (state.opt_ssl, jout.state.opt_ssl),
                      (state.opt_cm, jout.state.opt_cm)):
        got = to_jax_paths({n: opt.state[p]["exp_avg"] / 0.1
                            for n, p in zip(names, model.parameters())}, model)
        want = _flat(jax.tree.map(lambda m: m / 0.1, _mu(jopt)))
        assert got.keys() == want.keys()
        assert any(np.abs(v).max() > 0 for v in want.values())
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=5e-5, err_msg=k)
