"""Slice 3 of the port against the JAX package, on the CPU at fp32: the
packed-adjacency GCN (kernels/gcn.py against the Pallas kernel run in
interpret mode), the packed and store branches of decode_batch, the dataset
and embedding-cache copies, the device stores, the gather transport, the
metrics, and the device-resident training epoch and eval pass
(make_epoch_step_gather / make_eval_scan_gather) with the packed GCN on.

Tolerances: the GCN aggregate and its VJP 1e-5 (tests/test_kernels.py);
MolecularGCN packed forward 2e-5 (docs/PARITY.md's forward tolerance);
packed against dense rtol 2e-4 (tests/test_kernels.py); per-step losses
1e-5; parameters after 3 steps within 6·lr and 99% within 1e-6 (as
tests/test_torch_port_train.py, at lr 1e-5: see LR); eval probabilities 2e-5 and losses
1e-5.  Copies of host code and gathers are bit-identical."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import traverse_util

import druglamp_tpu.data.encoding as jenc
import druglamp_tpu.eval.metrics as jmet
import druglamp_tpu.kernels.dispatch as jdispatch
import druglamp_tpu.kernels.gcn_pallas as jgk
import druglamp_tpu.utils.synthetic as jsyn
from druglamp_tpu.config import SolverConfig
from druglamp_tpu.data.cache import EmbeddingCache as JCache
from druglamp_tpu.data.dataset import DTIDataset as JDataset
from druglamp_tpu.data.device_data import DeviceDataStore as JDataStore
from druglamp_tpu.data.device_data import cm_arrays_device as jcm_arrays
from druglamp_tpu.data.device_data import eval_index_plan as jeval_plan
from druglamp_tpu.data.device_data import gather_compact_batch as jgather
from druglamp_tpu.data.device_data import train_index_plan as jtrain_plan
from druglamp_tpu.data.device_store import DeviceEmbeddingStore as JEmbStore
from druglamp_tpu.data.loader import build_cm_arrays
from druglamp_tpu.nn.gcn import MolecularGCN as JMolecularGCN
from druglamp_tpu.train.state import TrainState as JTrainState
from druglamp_tpu.train.steps import make_epoch_step_gather as jmake_epoch
from druglamp_tpu.train.steps import make_eval_scan_gather as jmake_eval_scan
from druglamp_tpu_torch.convert import SKIPPED_SUBTREES, from_jax_params, to_jax_paths
from druglamp_tpu_torch.data import encoding as penc
from druglamp_tpu_torch.data.cache import EmbeddingCache
from druglamp_tpu_torch.data.dataset import DTIDataset
from druglamp_tpu_torch.data.device_data import (DeviceDataStore, cm_arrays_device,
                                                 eval_index_plan, gather_compact_batch,
                                                 train_index_plan)
from druglamp_tpu_torch.data.device_store import DeviceEmbeddingStore
from druglamp_tpu_torch.eval import metrics as pmet
from druglamp_tpu_torch.kernels import gcn as pgk
from druglamp_tpu_torch.nn.gcn import MolecularGCN
from druglamp_tpu_torch.train.state import TrainState
from druglamp_tpu_torch.train.steps import make_epoch_step_gather, make_eval_scan_gather
from tests.test_device_data import _make_csv_dataset, _RandEmb
from tests.torch_port_util import ND, NP, build_pair, port_config, to_torch

N = 256           # the Pallas kernel's row tile: the smallest N it takes
# Adam turns the sign of a near-zero gradient into a ±lr step, so later
# losses drift with lr: at 1e-4 the JAX package's own dense and packed
# paths differ by 4e-5 in the third loss on this data; at 1e-5 by < 1e-5.
LR = 1e-5
STEPS = 3
B = 4


def _cfg():
    return jsyn.tiny_config(n_hidden=16, max_nodes=N, site_seq=16, pmma_dropout=0.0,
                            solver=SolverConfig(compute_dtype="float32"))


def _graphs(Bg=3, n=N, seed=0):
    """Random molecules' adjacency: bonds among the first n_atoms nodes plus
    the universal self-loop, packed; ragged n_atoms (one graph full)."""
    r = np.random.RandomState(seed)
    n_atoms = r.randint(n // 8, n // 2, size=Bg)
    n_atoms[0] = n
    adj = np.zeros((Bg, n, n), np.uint8)
    ar = np.arange(n)
    for b in range(Bg):
        for _ in range(2 * n_atoms[b]):
            i, j = r.randint(0, n_atoms[b], 2)
            adj[b, i, j] = adj[b, j, i] = 1
        adj[b, ar, ar] = 1
    real = (ar[None, :] < n_atoms[:, None]).astype(np.float32)
    return jenc.pack_adjacency(adj), real


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jgk, "INTERPRET", True)


def _scales(packed, real):
    deg = np.asarray(jgk.packed_degrees(jnp.asarray(packed), jnp.asarray(real)))
    nrm = (1.0 / np.sqrt(np.maximum(deg, 1.0))).astype(np.float32)
    return nrm, (nrm * nrm * real).astype(np.float32)


# --- the packed GCN aggregate -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_packed_matmul_and_its_vjp_match_pallas(interpret, dtype):
    """Forward and VJP of the port (CPU: the plain version inside the
    autograd Function) against the Pallas kernel in interpret mode.  f32:
    atol = rtol = 1e-5.  bf16 x: the products with A are exact, so within
    1e-5 of the output's largest magnitude."""
    packed, real = _graphs()
    nrm, n2r = _scales(packed, real)
    r = np.random.RandomState(1)
    x32 = r.randn(*packed.shape[:2], 64).astype(np.float32)
    dy = r.randn(*x32.shape).astype(np.float32)
    jx = jnp.asarray(x32).astype(dtype)
    y_ref, vjp = jax.vjp(lambda x: jgk.gcn_packed_matmul(jnp.asarray(packed), jnp.asarray(nrm),
                                                          jnp.asarray(n2r), x), jx)
    dx_ref = vjp(jnp.asarray(dy))[0]

    tdt = getattr(torch, dtype)
    x = torch.from_numpy(x32).to(tdt).requires_grad_()
    before = dict(pgk.LAUNCHES)
    y = pgk.gcn_packed_matmul(*map(torch.from_numpy, (packed, nrm, n2r)), x)
    (dx,) = torch.autograd.grad(y, x, torch.from_numpy(dy))
    assert pgk.LAUNCHES == before                   # the CPU takes the plain version
    assert y.dtype == torch.float32 and dx.dtype == tdt
    y_ref, dx_ref = np.asarray(y_ref), np.asarray(dx_ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(y.detach().numpy() - y_ref).max() <= 1e-5 * np.abs(y_ref).max()
        # dx is rounded to bf16 once: one bf16 ulp of its largest magnitude
        ulp = 2.0 ** (np.floor(np.log2(np.abs(dx_ref).max())) - 7)
        assert np.abs(dx.float().numpy() - dx_ref).max() <= ulp


def test_gcn_packed_plain_autograd_matches_pallas_vjp(interpret):
    """The plain version differentiated by autograd (the route chip_smoke.py
    compares the kernel with on the card) against the Pallas VJP, f32."""
    packed, real = _graphs(seed=3)
    nrm, n2r = _scales(packed, real)
    r = np.random.RandomState(4)
    x32 = r.randn(*packed.shape[:2], 64).astype(np.float32)
    dy = r.randn(*x32.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jgk.gcn_packed_matmul(jnp.asarray(packed), jnp.asarray(nrm),
                                                      jnp.asarray(n2r), x), jnp.asarray(x32))
    x = torch.from_numpy(x32).requires_grad_()
    y = pgk.gcn_packed_plain(*map(torch.from_numpy, (packed, nrm, n2r)), x)
    (dx,) = torch.autograd.grad(y, x, torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]),
                               rtol=1e-5, atol=1e-5)


def test_packed_degrees_and_unpack_are_bit_identical():
    packed, real = _graphs(seed=5)
    jp, jr = jnp.asarray(packed), jnp.asarray(real)
    tp, tr = torch.from_numpy(packed), torch.from_numpy(real)
    deg = pgk.packed_degrees(tp, tr)
    assert deg.dtype == torch.float32
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jgk.packed_degrees(jp, jr)))
    adj = pgk.unpack_dense_adj(tp, tr)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jgk.unpack_dense_adj(jp, jr)))
    np.testing.assert_array_equal(deg.numpy(), adj.sum(-1).float().numpy())


@pytest.mark.parametrize("case", ["N", "C", "dtype", "shape", "contiguous", "device"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case):
    """check_operands raises on every operand the CUDA kernel cannot take
    (here on CPU tensors: the device check comes last)."""
    Bg, n, C = 2, 128, 64
    packed = torch.zeros(Bg, n, n // 8, dtype=torch.uint8)
    nrm = n2r = torch.ones(Bg, n)
    x = torch.zeros(Bg, n, C)
    if case == "N":
        packed, nrm, n2r, x = packed[:, :96, :12], nrm[:, :96], n2r[:, :96], x[:, :96]
    elif case == "C":
        x = torch.zeros(Bg, n, 48)
    elif case == "dtype":
        x = x.half()
    elif case == "shape":
        nrm = torch.ones(Bg, n + 1)
    elif case == "contiguous":
        x = torch.zeros(Bg, C, n).transpose(1, 2)
    with pytest.raises(ValueError, match="CUDA device" if case == "device" else None):
        pgk.check_operands(packed, nrm, n2r, x)


@pytest.mark.parametrize("env,device,want", [("1", "cuda", True), ("1", "cpu", False),
                                             ("0", "cuda", False), (None, "cuda", False)])
def test_use_packed_gcn_gate(monkeypatch, env, device, want):
    if env is None:
        monkeypatch.delenv("DRUGLAMP_PACKED_GCN", raising=False)
    else:
        monkeypatch.setenv("DRUGLAMP_PACKED_GCN", env)
    assert pgk.use_packed_gcn(torch.device(device)) is want


def test_molecular_gcn_packed_matches_jax_packed(interpret):
    """MolecularGCN on the packed path: the port against the JAX module run
    through the Pallas kernel, same weights (the bridge fills the port's GCN
    from the same tree on both paths), within 2e-5; the port's packed and
    dense paths agree within rtol 2e-4."""
    packed, real = _graphs(Bg=2, seed=6)
    r = np.random.RandomState(7)
    feats = (r.rand(2, N, 75) > 0.8).astype(np.float32)
    jadj = {"packed": jnp.asarray(packed), "real": jnp.asarray(real)}
    deg = jgk.packed_degrees(jadj["packed"], jadj["real"])
    dense = jgk.unpack_dense_adj(jadj["packed"], jadj["real"])
    jmod = JMolecularGCN(dim_embedding=16, hidden_feats=(16, 16, 16))
    v_packed = jmod.init(jax.random.key(0), jnp.asarray(feats), jadj, deg)
    v_dense = jmod.init(jax.random.key(0), jnp.asarray(feats), dense, deg)
    assert jax.tree.map(np.shape, v_packed) == jax.tree.map(np.shape, v_dense)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * r.randn(*a.shape).astype(np.float32),
                          v_packed["params"])
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.1 * r.rand(*a.shape).astype(np.float32),
                         v_packed["batch_stats"])
    ref = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(feats), jadj, deg)

    port = MolecularGCN(dim_embedding=16, hidden_feats=(16, 16, 16))
    state, skipped = from_jax_params(params, stats, port)
    assert not skipped
    port.load_state_dict(state)
    port.eval()
    tdeg = torch.from_numpy(np.array(deg))
    with torch.no_grad():
        got = port(torch.from_numpy(feats), {"packed": torch.from_numpy(packed),
                                             "real": torch.from_numpy(real)}, tdeg)
        got_dense = port(torch.from_numpy(feats), torch.from_numpy(np.array(dense)), tdeg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_dense.numpy(), got.numpy(), rtol=2e-4, atol=2e-5)


# --- decode_batch's packed and store branches ------------------------------------------

def _assert_same(got, ref, key=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), key
        for k in ref:
            _assert_same(got[k], ref[k], f"{key}.{k}")
        return
    ref = np.asarray(ref)
    if ref.dtype == ml_dtypes.bfloat16:
        assert got.dtype == torch.bfloat16, key
        got, ref = got.float().numpy(), ref.astype(np.float32)
    else:
        got = got.numpy()
        assert got.dtype == ref.dtype, (key, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=key)


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16)


def _port_tree(tree):
    """A JAX device tree as port tensors with the same bits."""
    out = {}
    for k, v in tree.items():
        v = np.asarray(v)
        out[k] = (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                  if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
    return out


@pytest.mark.parametrize("branch", ["keep_packed", "store", "store_keep_packed"])
def test_decode_batch_branches_are_bit_identical(branch):
    cfg = _cfg()
    b = jsyn.make_batch(cfg, 3, seed=8, n_drug_feature=ND, n_prot_feature=NP)
    batch = jenc.compact_batch(b, (b["d_fill"] == 0).sum(1))
    store = None
    if branch.startswith("store"):
        r = np.random.RandomState(9)
        del batch["xd"], batch["xp"], batch["d_ntok"]
        batch["drug_ord"] = np.array([2, 0, 2], np.int32)
        batch["prot_ord"] = np.array([1, 3, 0], np.int32)
        store = {"drug_emb": _bf16(r.randn(3, N, ND)), "drug_len": np.array([7, N, 0], np.int32),
                 "prot_emb": _bf16(r.randn(4, 60, NP)),
                 "prot_len": np.array([60, 13, 1, 0], np.int32)}
    keep = branch != "store"
    ref = jenc.decode_batch(jax.tree.map(jnp.asarray, batch),
                            None if store is None else jax.tree.map(jnp.asarray, store),
                            keep_packed=keep)
    got = penc.decode_batch(to_torch(batch), None if store is None else _port_tree(store),
                            keep_packed=keep)
    _assert_same(got, ref)
    assert isinstance(got["drug_adj"], dict) == keep


# --- dataset, cache, stores, gather transport ------------------------------------------

def _large_molecule_dataset(tmp_path, n=24):
    """The toy CSV dataset's layout with molecules of 60–120 atoms: with
    graphs of a few atoms in N = 256 nodes, the GCN's BatchNorm channels
    have a tiny batch variance in train mode, which magnifies the last-bit
    differences of any two f32 implementations beyond 1e-5."""
    smis = ["C" * 60, "C(C)" * 35, "CCO" * 30, "c1ccccc1" + "CC" * 40, "CN" * 50,
            "C1CCCCC1" + "C" * 100]
    prots = ["MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ", "MSEQNNTEMTFQIQRIYTKDIS", "MAHHHHHHVGTGSNG"]
    d = tmp_path / "toy" / "random"
    d.mkdir(parents=True)
    r = np.random.RandomState(0)
    rows = [f"{smis[i % len(smis)]},{prots[i % len(prots)]},{int(r.rand() < 0.5)}"
            for i in range(n)]
    for name, sl in (("train.csv", slice(0, n)), ("val.csv", slice(0, 10))):
        (d / name).write_text("\n".join(["SMILES,Protein,Y"] + rows[sl]) + "\n")
    return str(tmp_path)


def _datasets(tmp_path, cfg, make=_make_csv_dataset):
    root = make(tmp_path)
    kw = dict(max_nodes=cfg.drug.max_nodes, seq_len=cfg.protein.seq_len,
              max_prot_resis=cfg.protein.max_resis)
    jtrain = JDataset(root, "toy", "random", "train.csv", **kw)
    jval = JDataset(root, "toy", "random", "val.csv", table=jtrain.table, **kw)
    ptrain = DTIDataset(root, "toy", "random", "train.csv", **kw)
    pval = DTIDataset(root, "toy", "random", "val.csv", table=ptrain.table, **kw)
    return (jtrain, jval), (ptrain, pval)


def test_dataset_copy_is_bit_identical(tmp_path):
    (jtrain, jval), (ptrain, pval) = _datasets(tmp_path, _cfg())
    jt, pt = jtrain.table, ptrain.table
    assert (pt.drug2ord, pt.prot2ord, pt.ordinal_scope) == (jt.drug2ord, jt.prot2ord,
                                                            jt.ordinal_scope)
    for o in jt.drugs:
        assert pt.drugs[o].n_atoms == jt.drugs[o].n_atoms
        np.testing.assert_array_equal(pt.drugs[o].node_feats, jt.drugs[o].node_feats)
        np.testing.assert_array_equal(pt.drugs[o].edges, jt.drugs[o].edges)
    for o in jt.prots:
        assert pt.prots[o].fill_start == jt.prots[o].fill_start
        np.testing.assert_array_equal(pt.prots[o].codes, jt.prots[o].codes)
    for j, p in ((jtrain, ptrain), (jval, pval)):
        assert len(p) == len(j)
        for k in ("drug_ords", "prot_ords", "labels"):
            np.testing.assert_array_equal(getattr(p, k), getattr(j, k), err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_embedding_cache_reads_across_packages(tmp_path, writer):
    r = np.random.RandomState(10)
    drug, prot = r.randn(9, ND).astype(np.float32), r.randn(17, NP).astype(np.float32)
    w_cls, r_cls = (JCache, EmbeddingCache) if writer == "jax" else (EmbeddingCache, JCache)
    w = w_cls(str(tmp_path), "toy", ND, NP)
    w.put_drug(3, drug)
    w.put_prot(5, prot)
    rd = r_cls(str(tmp_path), "toy", ND, NP)
    assert rd.has_drug(3) and rd.has_prot(5) and not rd.has_drug(4)
    np.testing.assert_array_equal(rd.drug(3), drug)
    np.testing.assert_array_equal(rd.prot(5), prot)
    assert w.drug_path(3) == rd.drug_path(3) and w.prot_path(5) == rd.prot_path(5)


def test_device_embedding_store_is_bit_identical(tmp_path):
    cfg = _cfg()
    (jtrain, _), (ptrain, _) = _datasets(tmp_path, cfg)
    emb = _RandEmb()
    kw = dict(max_drug_tokens=cfg.drug.max_nodes, max_prot_len=cfg.protein.max_resis + 2)
    jstore = JEmbStore.build(jtrain.table, emb, **kw)
    pstore = DeviceEmbeddingStore.build(ptrain.table, emb, device="cpu", **kw)
    _assert_same(pstore.tree, jstore.tree)
    assert DeviceEmbeddingStore.estimate_bytes(ptrain.table, emb, **kw) \
        == JEmbStore.estimate_bytes(jtrain.table, emb, **kw)
    assert DeviceEmbeddingStore.build(ptrain.table, emb, budget_bytes=1, device="cpu",
                                      **kw) is None


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "same_prot", "all_same",
                                  "all_distinct"])
def test_cm_arrays_device_matches_jax_and_host(case):
    """The seeds and edge cases of tests/test_device_data.py."""
    if case.startswith("seed"):
        r = np.random.RandomState(int(case[-1]))
        pid = r.randint(0, 3, size=8).astype(np.int32)
        did = r.randint(0, 5, size=8).astype(np.int32)
        labels = r.randint(0, 2, size=8).astype(np.float32)
    else:
        pid = np.zeros(6, np.int32) if case != "all_distinct" else np.arange(6, dtype=np.int32)
        did = np.zeros(6, np.int32) if case == "all_same" else np.arange(6, dtype=np.int32)
        labels = (np.arange(6) % 2).astype(np.float32)
    got = cm_arrays_device(*map(torch.from_numpy, (pid, did, labels)))
    _assert_same(got, jcm_arrays(*map(jnp.asarray, (pid, did, labels))))
    host = build_cm_arrays(pid, did, labels)
    for k in host:
        np.testing.assert_array_equal(got[k].numpy().astype(host[k].dtype), host[k], err_msg=k)


@pytest.mark.parametrize("mode", ["wollm", "ordinals"])
def test_gather_transport_is_bit_identical(tmp_path, mode):
    """Data stores, index plans and every gathered batch of a train epoch
    and an eval pass (ragged tail) equal the JAX package's."""
    cfg = _cfg()
    (jtrain, jval), (ptrain, pval) = _datasets(tmp_path, cfg)
    llm = mode == "ordinals"
    jstore = JDataStore.build(jtrain.table, cfg.drug.max_nodes, cfg.protein.seq_len, llm, llm)
    pstore = DeviceDataStore.build(ptrain.table, cfg.drug.max_nodes, cfg.protein.seq_len, llm,
                                   llm, device="cpu")
    assert pstore.nbytes() == jstore.nbytes()
    _assert_same(pstore.entities, jstore.entities)
    fake = {"sentinel": jnp.zeros(())} if llm else None
    order = np.random.RandomState(11).permutation(len(jtrain))
    plans = [(jtrain, ptrain, jtrain_plan(order, B), np.ones((len(jtrain) // B, B), np.float32)),
             (jval, pval, *jeval_plan(len(jval), B))]
    np.testing.assert_array_equal(train_index_plan(order, B), plans[0][2])
    for got, ref in zip(eval_index_plan(len(pval), B), plans[1][2:]):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    for jds, pds, idx, valid in plans:
        jtree, ptree = jstore.tree_for(jds), pstore.tree_for(pds)
        _assert_same(ptree, jtree)
        for s in range(idx.shape[0]):
            ref = jgather(jtree, jnp.asarray(idx[s]), jnp.asarray(valid[s]), llm, llm, fake)
            got = gather_compact_batch(ptree, torch.from_numpy(idx[s]),
                                       torch.from_numpy(valid[s]), llm, llm, fake)
            _assert_same(got, ref)


# --- metrics ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_are_bit_identical(seed):
    r = np.random.RandomState(seed)
    preds = np.round(r.rand(200), 2)                 # rounded: ties between scores
    targets = (r.rand(200) < 0.3).astype(np.int64)
    assert pmet.auroc(preds, targets) == jmet.auroc(preds, targets)
    assert pmet.average_precision(preds, targets) == jmet.average_precision(preds, targets)
    assert pmet.binary_metrics(preds, targets) == jmet.binary_metrics(preds, targets)
    pc, jc = pmet.MetricCollector(), jmet.MetricCollector()
    for sl in (slice(0, 70), slice(70, 200)):
        pc.update(preds[sl], targets[sl])
        jc.update(preds[sl], targets[sl])
    assert pc.compute(full=True) == jc.compute(full=True)
    assert np.isnan(pmet.auroc(preds, np.zeros(200)))


# --- the device-resident epoch and eval pass ---------------------------------------------

def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()
            if k[0] not in SKIPPED_SUBTREES}


@pytest.fixture(scope="module")
def epoch_runs(tmp_path_factory):
    """DrugLAMP (LLM stream from the embedding store, pre-gathered), f32,
    dropout 0, packed GCN on in both packages (JAX: Pallas backend in
    interpret mode and DRUGLAMP_PACKED_GCN=1; port: the gate forced on, so
    the CPU takes the plain version inside the autograd Function).  The eval
    pass on the validation split (ragged tail) runs first, on the initial
    weights; then S=3 train steps from the same weights; then the port's
    same 3 steps with the dense adjacency."""
    cfg = _cfg()
    (jtrain, jval), (ptrain, pval) = _datasets(tmp_path_factory.mktemp("dd"), cfg,
                                               _large_molecule_dataset)
    emb = _RandEmb()
    kw = dict(max_drug_tokens=cfg.drug.max_nodes, max_prot_len=cfg.protein.max_resis + 2)
    jemb, pemb = JEmbStore.build(jtrain.table, emb, **kw).tree, \
        DeviceEmbeddingStore.build(ptrain.table, emb, device="cpu", **kw).tree
    args = (cfg.drug.max_nodes, cfg.protein.seq_len, True, True)
    jstore, pstore = JDataStore.build(jtrain.table, *args), \
        DeviceDataStore.build(ptrain.table, *args, device="cpu")
    idx = train_index_plan(np.random.RandomState(12).permutation(len(jtrain)), B)[:STEPS]
    ones = np.ones(idx.shape, np.float32)
    eidx, evalid = eval_index_plan(len(jval), B)
    jmodel, params, stats, pmodel = build_pair("DrugLAMP", cfg)
    j, p = {}, {}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgk, "INTERPRET", True)
        mp.setattr(jdispatch, "_BACKEND", "pallas")
        mp.setenv("DRUGLAMP_PACKED_GCN", "1")
        jtree, jvtree = jstore.tree_for(jtrain), jstore.tree_for(jval)
        probs, losses = jmake_eval_scan(jmodel, True, True)(
            params, stats, jnp.asarray(eidx), jnp.asarray(evalid), jvtree, jemb)
        j["eval"] = (np.asarray(probs), np.asarray(losses))
        state = JTrainState.create({"params": jax.tree.map(jnp.array, params),
                                    "batch_stats": jax.tree.map(jnp.array, stats)},
                                   use_ssl=False, use_cm=False)
        out = jmake_epoch(jmodel, False, False, True, True)(
            state, jnp.asarray(idx), jnp.asarray(ones), jtree, jemb, jax.random.key(0),
            *map(jnp.float32, (LR, 0.0, 0.0, 0.5, 1.0)))
        j["losses"] = np.asarray(out.cls_losses)
        j["state"] = {**_flat(out.state.params), **_flat(out.state.batch_stats)}

    initial = {k: v.clone() for k, v in pmodel.state_dict().items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pgk, "use_packed_gcn", lambda device: True)
        ptree, pvtree = pstore.tree_for(ptrain), pstore.tree_for(pval)
        probs, losses = make_eval_scan_gather(pmodel, True, True, device="cpu")(
            eidx, evalid, pvtree, pemb)
        p["eval"] = (probs.numpy(), losses.numpy())
        pstate = TrainState.create(pmodel)
        out = make_epoch_step_gather(pmodel, False, False, True, True, device="cpu")(
            pstate, idx, ones, ptree, pemb, torch.Generator().manual_seed(0), LR)
        p["losses"] = out.cls_losses.numpy()
        p["state"] = to_jax_paths(pmodel.state_dict(), pmodel)
        p["steps"] = (pstate.step, out.ssl_losses.shape, float(out.cm_weight))

    pmodel.load_state_dict(initial)
    out = make_epoch_step_gather(pmodel, False, False, True, True, device="cpu")(
        TrainState.create(pmodel), idx, ones, ptree, pemb, None, LR)
    p["dense_losses"] = out.cls_losses.numpy()
    return j, p


def test_epoch_losses_match_jax(epoch_runs):
    j, p = epoch_runs
    assert p["losses"].shape == (STEPS,) and p["steps"] == (STEPS, (STEPS,), 1.0)
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=0, atol=1e-5)


def test_epoch_parameters_match_jax(epoch_runs):
    j, p = epoch_runs
    ref, got = j["state"], p["state"]
    assert set(got) == set(ref)
    diffs = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert diffs.max() <= 6 * LR, diffs.max()
    assert np.mean(diffs <= 1e-6) >= 0.99, np.mean(diffs <= 1e-6)


def test_eval_scan_matches_jax(epoch_runs):
    j, p = epoch_runs
    assert p["eval"][0].shape == j["eval"][0].shape == (3, B)
    np.testing.assert_allclose(p["eval"][0], j["eval"][0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(p["eval"][1], j["eval"][1], rtol=0, atol=1e-5)


def test_epoch_dense_adjacency_matches_packed(epoch_runs):
    """The port's dense path (the CPU default) against its packed path, f32."""
    _, p = epoch_runs
    np.testing.assert_allclose(p["dense_losses"], p["losses"], rtol=2e-4, atol=1e-6)
