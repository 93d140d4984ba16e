"""The port's host pipeline against the JAX package's, on the CPU at a tiny
DrugLAMP2C2P (fp32).

- The loader (numpy only, no JAX program): ``BatchLoader``'s batches are
  bit-identical to the JAX loader's (the bf16 LLM arrays compared as uint16
  bit patterns), for LLM arrays from a seeded ``EmbeddingCache`` at real
  token lengths (converted to bf16 at load, and not), ``ZeroEmbeddings``,
  woLLM batches and ordinal batches, with a ragged tail; the eval loader's
  batch cache behaves as the JAX loader's; the prefetch thread yields what
  the inline assembly yields; ``EmbeddingCache(dtype=torch.bfloat16)``
  rounds as ``ml_dtypes`` does, bit for bit, ties, infinities and
  subnormals included.  ``Trainer._DevicePrefetch`` delivers every batch in
  order at any depth.
- Zero-length embeddings (``ZeroEmbeddings``: ``d_ntok`` = ``xp_len`` = 0,
  every LLM position fill): the JAX package's forward stays finite on such a
  batch, and the port's gives its scores within 2e-5.
- Transports, port against port: the host pipeline with the LLM arrays (its
  batches assembled on the prefetch thread, or inline; ``solver.scan_chunk``
  64 or 3, which the port does not read), the host pipeline over the ordinal
  store and the gather epoch give bit-identical parameters, per-epoch
  losses, CM weight and validation metrics over a 2-epoch fit with dropout
  on (the generator's draws come in the same order), and their ``evaluate``
  gives the same metrics.
- The host-pipeline ``Trainer`` against the JAX package's (``device_data``
  None, the JAX one in scan mode, LLM arrays from the cache): 2 epochs (cls; ssl + cm +
  calibrate), dropout 0, one fixed MLM mask in both, the JAX initial weights
  through ``convert.py``: per-epoch losses and validation AUSum 1e-5, the CM
  weight exact, the test metrics on the best state 1e-5.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import druglamp_tpu.models.ssl as jssl
from druglamp_tpu.data.cache import EmbeddingCache as JCache
from druglamp_tpu.data.cache import ZeroEmbeddings as JZero
from druglamp_tpu.data.dataset import DTIDataset as JDataset
from druglamp_tpu.data.encoding import decode_batch as jdecode
from druglamp_tpu.data.loader import BatchLoader as JBatchLoader
from druglamp_tpu.train.state import TrainState as JTrainState
from druglamp_tpu.train.trainer import Trainer as JTrainer
from druglamp_tpu.utils.logging import ExperimentLogger as JLogger
from druglamp_tpu_torch.data.cache import EmbeddingCache, ZeroEmbeddings, bf16_bits
from druglamp_tpu_torch.data.dataset import DTIDataset
from druglamp_tpu_torch.data.device_data import DeviceDataStore
from druglamp_tpu_torch.data.device_store import DeviceEmbeddingStore
from druglamp_tpu_torch.data.encoding import decode_batch
from druglamp_tpu_torch.data.loader import BatchLoader
from druglamp_tpu_torch.losses import masking as pmask
from druglamp_tpu_torch.models.registry import build_model
from druglamp_tpu_torch.train.state import TrainState
from druglamp_tpu_torch.train.steps import to_device
from druglamp_tpu_torch.train.trainer import Trainer, _DevicePrefetch
from druglamp_tpu_torch.utils.logging import ExperimentLogger
from tests.test_torch_port_ssl_cm import _jax_fixed_mask, _port_fixed_mask
from tests.test_torch_port_trainer import (B, SEED, _cfg, _full_port_config, _records,
                                           _toy_dataset)
from tests.torch_port_util import ND, NP, SCORE_ATOL, build_pair

N_TRAIN, N_EVAL = 18, 10          # 4 training batches and a ragged tail of 2; eval 4+4+2


def _kw(cfg):
    return dict(max_nodes=cfg.drug.max_nodes, seq_len=cfg.protein.seq_len,
                max_prot_resis=cfg.protein.max_resis)


def _seed_cache(path, table, cfg):
    """Seeded random embeddings at the real token lengths: a drug
    len(SMILES) + 2 rows capped at max_nodes, a protein min(len, max_resis)
    + 2 rows."""
    cache = EmbeddingCache(path, "toy", ND, NP)
    r = np.random.RandomState(11)
    for smi, o in table.drug2ord.items():
        cache.put_drug(o, r.randn(min(len(smi) + 2, cfg.drug.max_nodes), ND))
    for seq, o in table.prot2ord.items():
        cache.put_prot(o, r.randn(min(len(seq), cfg.protein.max_resis) + 2, NP))
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The toy CSVs, both packages' training and eval datasets, and a seeded
    embedding cache on disk."""
    cfg = _cfg(epochs=2)
    root = _toy_dataset(str(tmp_path_factory.mktemp("data")), n_train=N_TRAIN, n_eval=N_EVAL)
    train = DTIDataset(root, "toy", "random", "train.csv", **_kw(cfg))
    val = DTIDataset(root, "toy", "random", "val.csv", table=train.table, **_kw(cfg))
    jtrain = JDataset(root, "toy", "random", "train.csv", **_kw(cfg))
    jval = JDataset(root, "toy", "random", "val.csv", table=jtrain.table, **_kw(cfg))
    cache_dir = _seed_cache(os.path.join(root, "cache"), train.table, cfg)
    return {"cfg": cfg, "root": root, "train": train, "val": val, "jtrain": jtrain,
            "jval": jval, "cache": cache_dir}


@pytest.fixture(scope="module")
def pair(world):
    """The JAX DrugLAMP2C2P with seeded weights and the port's copy of it."""
    return build_pair("DrugLAMP2C2P", world["cfg"])


def _sources(world, name):
    """(port embedding source, JAX embedding source) by name."""
    d = world["cache"]
    if name == "cache_bf16":
        return (EmbeddingCache(d, "toy", ND, NP, dtype=torch.bfloat16),
                JCache(d, "toy", ND, NP, dtype=ml_dtypes.bfloat16))
    if name == "cache_f32":
        return EmbeddingCache(d, "toy", ND, NP), JCache(d, "toy", ND, NP)
    return ZeroEmbeddings(ND, NP), JZero(ND, NP)


def _assert_batches_equal(got, ref, path=""):
    assert set(got) == set(ref), (path, set(got) ^ set(ref))
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_batches_equal(got[k], ref[k], f"{path}{k}.")
            continue
        r = ref[k].view(np.uint16) if ref[k].dtype == ml_dtypes.bfloat16 else ref[k]
        assert got[k].dtype == r.dtype and got[k].shape == r.shape, (path + k, got[k].dtype,
                                                                      r.dtype)
        np.testing.assert_array_equal(got[k], r, err_msg=path + k)


# (include_llm, emb_ordinals): bf16 LLM arrays, woLLM, ordinals
MODES = {"llm": (True, False), "wollm": (False, False), "ordinals": (True, True)}


# --- the loader ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["cache_bf16", "cache_f32", "zero"])
@pytest.mark.parametrize("mode", list(MODES))
def test_loader_batches_are_bit_identical(world, source, mode):
    """Every batch of a shuffled epoch (ragged tail padded) and of the eval
    loader, and the first batch, equal the JAX loader's."""
    include_llm, ords = MODES[mode]
    pemb, jemb = _sources(world, source)
    for shuffle, ds, jds in ((True, world["train"], world["jtrain"]),
                             (False, world["val"], world["jval"])):
        kw = dict(shuffle=shuffle, drop_last=False, seed=SEED, include_llm=include_llm,
                  emb_ordinals=ords)
        pl = BatchLoader(ds, B, embeddings=pemb, **kw)
        jl = JBatchLoader(jds, B, embeddings=jemb, compact=True, **kw)
        got, ref = list(pl.epoch(3)), list(jl.epoch(3))
        assert len(got) == len(ref) == len(pl) == len(jl)
        assert got[-1]["valid"].sum() < B            # the ragged tail
        for g, r in zip(got, ref):
            _assert_batches_equal(g, r)
        _assert_batches_equal(pl.first_batch(2), jl.first_batch(2))
    if include_llm and not ords and source != "zero":
        assert got[0]["xd"].dtype == np.uint16 and got[0]["xd"].any()


@pytest.mark.parametrize("shuffle", [True, False])
def test_prefetch_thread_matches_inline_assembly(world, shuffle):
    """``epoch`` with the worker thread (prefetch 2) yields the batches of
    the inline assembly (prefetch 0) in the same order, and leaves no
    thread behind."""
    import threading

    pemb, _ = _sources(world, "cache_bf16")
    ds = world["train"] if shuffle else world["val"]
    kw = dict(shuffle=shuffle, drop_last=False, seed=SEED, embeddings=pemb)
    before = threading.active_count()
    got = list(BatchLoader(ds, B, prefetch=2, **kw).epoch(4))
    ref = list(BatchLoader(ds, B, prefetch=0, **kw).epoch(4))
    assert threading.active_count() == before
    assert len(got) == len(ref) == -(-len(ds) // B)
    for g, r in zip(got, ref):
        _assert_batches_equal(g, r)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_delivers_every_batch_in_order(world, depth):
    """``_DevicePrefetch`` at any depth yields each host batch once, in
    order, beside its device copy, with the embedding store attached."""
    pemb, _ = _sources(world, "cache_bf16")
    loader = BatchLoader(world["train"], B, shuffle=True, drop_last=False, seed=SEED,
                         embeddings=pemb, prefetch=0)
    store = {"drug_emb": torch.zeros(1)}
    hosts = list(loader.epoch(1))
    feed = _DevicePrefetch(iter(hosts), torch.device("cpu"), store, depth=depth)
    out = list(feed)
    feed.release()
    assert [h is g for (h, _), g in zip(out, hosts)] == [True] * len(hosts) == [True] * len(out)
    for host, dev in out:
        assert dev["_store"] is store
        assert torch.equal(dev["labels"], torch.from_numpy(host["labels"]))
        assert torch.equal(dev["xd"].view(torch.int16),
                           torch.from_numpy(host["xd"].view(np.int16)))


def test_eval_loader_batch_cache(world):
    """An unshuffled loader keeps its first pass's batches while they fit in
    cache_max_bytes and yields the same arrays again; past the cap it keeps
    none, as the JAX loader."""
    pemb, jemb = _sources(world, "cache_bf16")
    for cap in (2 << 30, 1000):
        pl = BatchLoader(world["val"], B, shuffle=False, drop_last=False, embeddings=pemb,
                         cache_max_bytes=cap)
        jl = JBatchLoader(world["jval"], B, shuffle=False, drop_last=False, embeddings=jemb,
                          compact=True, cache_max_bytes=cap)
        first, jfirst = list(pl.epoch(0)), list(jl.epoch(0))
        again = list(pl.epoch(5))
        list(jl.epoch(5))
        assert (pl._batch_cache is None) == (jl._batch_cache is None) == (cap == 1000)
        assert all((a is b) == (cap != 1000) for a, b in zip(first, again))
        for g, r in zip(again, jfirst):
            _assert_batches_equal(g, r)


def test_prefetch_worker_error_reaches_the_caller(world):
    """An assembly error on the prefetch thread is raised on the consuming
    thread, not lost with a short epoch."""
    pl = BatchLoader(world["train"], B, shuffle=True, drop_last=True, prefetch=2)

    def broken(idx):
        raise RuntimeError("assembly failed")

    pl._assemble_compact = broken
    with pytest.raises(RuntimeError, match="assembly failed"):
        list(pl.epoch(0))


def test_bf16_cache_rounds_as_ml_dtypes(world):
    """The cache's bf16 conversion equals ml_dtypes' round to nearest even
    bit for bit: on the cached embeddings, and on ties (low half exactly
    0x8000, even and odd high halves), neighbours of ties, infinities,
    subnormals, signed zeros and the largest finite values."""
    d = world["cache"]
    got = EmbeddingCache(d, "toy", ND, NP, dtype=torch.bfloat16)
    ref = JCache(d, "toy", ND, NP, dtype=ml_dtypes.bfloat16)
    table = world["train"].table
    for o in range(table.n_drug):
        np.testing.assert_array_equal(got.drug(o), ref.drug(o).view(np.uint16))
    for o in range(table.n_prot):
        np.testing.assert_array_equal(got.prot(o), ref.prot(o).view(np.uint16))
    hi = np.arange(0, 1 << 16, 97, dtype=np.uint32)
    bits = np.concatenate([(hi << 16) | low for low in (0x8000, 0x7FFF, 0x8001, 0x0001,
                                                        0xFFFF)])
    x = np.concatenate([bits.view(np.float32),
                        np.array([np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
                                  np.finfo(np.float32).max, np.finfo(np.float32).tiny],
                                 np.float32)])
    not_nan = ~np.isnan(x)
    np.testing.assert_array_equal(bf16_bits(x)[not_nan],
                                  x[not_nan].astype(ml_dtypes.bfloat16).view(np.uint16))


# --- zero-length embeddings ---------------------------------------------------------------

def test_zero_embeddings_forward_matches_jax(world, pair):
    """A batch of ZeroEmbeddings (every LLM position fill): the JAX package's
    eval forward is finite, and the port's scores are within 2e-5 of it."""
    jmodel, params, stats, pmodel = pair
    pemb, jemb = _sources(world, "zero")
    host = BatchLoader(world["val"], B, shuffle=False, drop_last=False,
                       embeddings=pemb).first_batch()
    jhost = JBatchLoader(world["jval"], B, shuffle=False, drop_last=False, embeddings=jemb,
                         compact=True).first_batch()
    assert not host["d_ntok"].any() and not host["xp_len"].any()
    ref = jmodel.apply({"params": params, "batch_stats": stats},
                       jdecode(jax.tree.map(jnp.asarray, jhost)), train=False)["score"]
    assert np.isfinite(np.asarray(ref)).all()
    with torch.no_grad():
        out = pmodel(decode_batch(to_device(host, torch.device("cpu"))))["score"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=SCORE_ATOL)


# --- transports, port against port --------------------------------------------------------

def _port_fit(world, transport, work, dropout):
    """A 2-epoch fit (cls; ssl + cm + calibrate) and the evaluate of its
    final state on the validation split, through one transport; → (records,
    final parameters, CM weight, evaluate)."""
    cfg = _full_port_config(_cfg(epochs=2, dropout=dropout, lr=1e-3))
    chunk = 3 if transport == "scan_chunk" else 64
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, scan_chunk=chunk))
    cache = EmbeddingCache(world["cache"], "toy", ND, NP, dtype=torch.bfloat16)
    ords = transport in ("ordinals", "gather")
    loaders = [BatchLoader(ds, B, shuffle=sh, drop_last=sh, embeddings=cache, seed=SEED,
                           emb_ordinals=ords, prefetch=0 if transport == "no_prefetch" else 2)
               for ds, sh in ((world["train"], True), (world["val"], False),
                              (world["val"], False))]
    store = data = None
    if ords:
        store = DeviceEmbeddingStore.build(world["train"].table, cache,
                                           max_drug_tokens=cfg.drug.max_nodes,
                                           max_prot_len=cfg.protein.max_resis + 2,
                                           device="cpu").tree
    if transport == "gather":
        data = DeviceDataStore.build(world["train"].table, cfg.drug.max_nodes,
                                     cfg.protein.seq_len, True, True, device="cpu")
        assert DeviceDataStore.supports(loaders[0])
    else:
        assert not DeviceDataStore.supports(loaders[0]) or transport == "ordinals"
    model = build_model("DrugLAMP2C2P", cfg, ND, NP, generator=torch.Generator().manual_seed(4))
    log = ExperimentLogger(str(work), transport, quiet=True)
    t = Trainer(model, cfg, *loaders, logger=log, work_dir=str(work / transport),
                embed_store=store, device_data=data, device="cpu")
    assert t.transport == ("gather" if transport == "gather" else "host")
    t.patience = 2
    state = TrainState.create(model, True, True)
    t.fit(state, SEED)
    records = [{k: v for k, v in r.items() if k not in ("t", "epoch_time_s", "pairs_per_s")}
               for r in _records(log.jsonl_path) if "train_loss" in r]
    return (records, [p.detach().clone() for p in model.parameters()], t.cm_weight,
            t.evaluate(state, loaders[1], full=True))


@pytest.fixture(scope="module")
def transports(world, tmp_path_factory):
    work = tmp_path_factory.mktemp("transports")
    return {tr: _port_fit(world, tr, work, dropout=0.1)
            for tr in ("host", "no_prefetch", "scan_chunk", "ordinals", "gather")}


@pytest.mark.parametrize("transport", ["ordinals", "gather", "no_prefetch", "scan_chunk"])
def test_transports_are_bit_identical(transports, transport):
    """Against the host pipeline with the LLM arrays: the host pipeline over
    the ordinal store, the gather epoch on the same order, the batches
    assembled inline (prefetch 0) in place of the worker thread, and
    ``solver.scan_chunk`` 3 in place of 64.  The batches are equal bit for
    bit (the store holds the cache's bf16 rows) and the steps take the
    generator's draws in one order, so everything is exact."""
    (rec, params, w, ev), (rrec, rparams, rw, rev) = transports[transport], transports["host"]
    assert len(rec) == 2 and "cm_loss" in rec[1] and "ssl_loss" in rec[1]
    assert rec == rrec
    assert w == rw
    assert all(torch.equal(a, b) for a, b in zip(params, rparams))
    assert ev == rev


# --- the host-pipeline Trainer against the JAX package's ----------------------------------

@pytest.fixture(scope="module")
def host_fits(world, pair, tmp_path_factory):
    """Both packages' host-pipeline Trainers (the JAX one in scan mode, LLM
    arrays from the bf16 cache) over 2 epochs from the same weights, the
    mask injected."""
    work = tmp_path_factory.mktemp("host_fits")
    cfg = world["cfg"]
    jmodel, params, stats, pmodel = pair
    pemb, jemb = _sources(world, "cache_bf16")
    jl = [JBatchLoader(ds, B, shuffle=sh, drop_last=sh, embeddings=jemb, seed=SEED,
                       compact=True) for ds, sh in ((world["jtrain"], True),
                                                    (world["jval"], False),
                                                    (world["jval"], False))]
    pl = [BatchLoader(ds, B, shuffle=sh, drop_last=sh, embeddings=pemb, seed=SEED)
          for ds, sh in ((world["train"], True), (world["val"], False), (world["val"], False))]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssl, "mlm_mask", _jax_fixed_mask)
        mp.setattr(pmask, "mlm_mask", _port_fixed_mask)
        mp.setenv("DRUGLAMP_SYNC_CKPT", "1")
        jlog = JLogger(str(work), "jax", quiet=True)
        jt = JTrainer(jmodel, cfg, *jl, logger=jlog, work_dir=str(work / "jax_run"))
        jt.patience = 2
        jstate = JTrainState.create({"params": jax.tree.map(jnp.array, params),
                                     "batch_stats": jax.tree.map(jnp.array, stats)}, True, True)
        jt.fit(jstate, SEED)
        out["jax"] = {"records": _records(jlog.jsonl_path), "best_epoch": jt.best_epoch,
                      "cm_weight": jt.cm_weight,
                      "test": jt.evaluate(jt._best_state, jl[2], full=True)}

        plog = ExperimentLogger(str(work), "port", quiet=True)
        pt = Trainer(copy.deepcopy(pmodel), _full_port_config(cfg), *pl, logger=plog,
                     work_dir=str(work / "port_run"), device="cpu")
        assert pt.transport == "host"
        pt.patience = 2
        test = pt.run_experiment(SEED, state=TrainState.create(pt.model, True, True))
        out["port"] = {"records": _records(plog.jsonl_path), "best_epoch": pt.best_epoch,
                       "cm_weight": pt.cm_weight, "test": test}
    return out


def test_host_fit_per_epoch_matches_jax(host_fits):
    """Epoch 1 cls only, epoch 2 ssl + cm with the calibration: losses and
    validation AUROC/AUPRC/AUSum and loss 1e-5, the LR, margin and CM weight
    equal, the same best epoch."""
    ref = [r for r in host_fits["jax"]["records"] if "train_loss" in r]
    got = [r for r in host_fits["port"]["records"] if "train_loss" in r]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref] == [1, 2]
    assert "ssl_loss" in got[1] and "cm_loss" in got[1] and "ssl_loss" not in got[0]
    for g, r in zip(got, ref):
        assert set(g) == set(r), set(g) ^ set(r)
        for k in r:
            if k in ("t", "epoch_time_s", "pairs_per_s"):
                continue
            if k in ("epoch", "lr", "margin", "cm_weight"):
                assert g[k] == r[k], (r["epoch"], k, g[k], r[k])
            else:
                assert abs(g[k] - r[k]) <= 1e-5, (r["epoch"], k, g[k], r[k])
    assert host_fits["port"]["cm_weight"] == host_fits["jax"]["cm_weight"]
    assert host_fits["port"]["best_epoch"] == host_fits["jax"]["best_epoch"]


def test_host_test_metrics_on_the_best_state_match_jax(host_fits):
    got, ref = host_fits["port"]["test"], host_fits["jax"]["test"]
    assert set(got) == set(ref)
    for k in ("auroc", "auprc", "ausum", "loss"):
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])
