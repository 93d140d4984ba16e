"""The last modules of the JAX package to come into the port, each held to the
JAX package on seeded inputs at fp32 on the CPU:

- ``losses/focal.py::focal_loss`` (every reduction, rel 1e-6; the formula
  of tests/test_losses.py);
- ``nn/norms.py::GainLayerNorm`` (1e-6 at f32; one bf16 ulp at bf16);
- PMMA's ``linattn`` variant (``build_model(..., pmma_variant="linattn")``:
  blocks ≥ 2 multi-head linear attention): the eval forward's score within
  2e-5 and the train-mode cls gradients within rtol 5e-3 / atol 5e-5 of
  JAX's, dropout 0;
- ``data/partition.py::partition_data``, ``data/inspect.py::
  find_in_train_set``, ``chem/protein_features.py``'s ``seq_feature`` and
  ``prot_feature``: the same outputs, bit for bit;
- ``Trainer.fast_dev_run``: DrugLAMP2C2P with every gate of the recipe on,
  dropout 0, the fixed MLM mask, seeded f32 embedding caches, both
  packages from the same weights over their host pipelines: the per-batch cls losses and the validation
  metrics within 1e-5 (the fit tolerance of tests/test_torch_port_trainer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import druglamp_tpu.models.ssl as jssl
import druglamp_tpu.utils.synthetic as jsyn
from druglamp_tpu.chem import protein_features as jpf
from druglamp_tpu.config import RSConfig as JRSConfig
from druglamp_tpu.config import SolverConfig as JSolverConfig
from druglamp_tpu.data.cache import EmbeddingCache as JCache
from druglamp_tpu.data.dataset import DTIDataset as JDataset
from druglamp_tpu.data.inspect import find_in_train_set as jfind
from druglamp_tpu.data.loader import BatchLoader as JBatchLoader
from druglamp_tpu.data.partition import partition_data as jpartition
from druglamp_tpu.losses.classification import binary_cross_entropy as jbce
from druglamp_tpu.losses.focal import focal_loss as jfocal
from druglamp_tpu.models.registry import build_model as jax_build_model
from druglamp_tpu.nn.norms import GainLayerNorm as JGainLayerNorm
from druglamp_tpu.train.state import TrainState as JTrainState
from druglamp_tpu.train.trainer import Trainer as JTrainer
from druglamp_tpu.utils.synthetic import tiny_config
from druglamp_tpu_torch.chem import protein_features as ppf
from druglamp_tpu_torch.convert import from_jax_params, to_jax_paths
from druglamp_tpu_torch.data.cache import EmbeddingCache
from druglamp_tpu_torch.data.dataset import DTIDataset
from druglamp_tpu_torch.data.encoding import decode_batch
from druglamp_tpu_torch.data.inspect import find_in_train_set as pfind
from druglamp_tpu_torch.data.loader import BatchLoader
from druglamp_tpu_torch.data.partition import partition_data as ppartition
from druglamp_tpu_torch.losses import masking as pmask
from druglamp_tpu_torch.losses.focal import focal_loss
from druglamp_tpu_torch.models.registry import build_model as port_build_model
from druglamp_tpu_torch.nn.norms import GainLayerNorm
from druglamp_tpu_torch.train import steps as psteps
from druglamp_tpu_torch.train.state import TrainState
from druglamp_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_host_pipeline import _seed_cache
from tests.test_torch_port_ssl_cm import _jax_fixed_mask, _port_fixed_mask
from tests.test_torch_port_trainer import _full_port_config, _toy_dataset
from tests.torch_port_util import ND, NP, jax_variables, port_config, tiny_cfg, to_torch


# --- focal loss, GainLayerNorm ----------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_focal_loss_matches_jax(reduction):
    r = np.random.RandomState(0)
    logits = (3 * r.randn(64)).astype(np.float32)
    labels = (r.rand(64) > 0.5).astype(np.float32)
    got = focal_loss(torch.from_numpy(logits), torch.from_numpy(labels), alpha=0.3, gamma=1.5,
                     reduction=reduction).numpy()
    want = np.asarray(jfocal(jnp.asarray(logits), jnp.asarray(labels), alpha=0.3, gamma=1.5,
                             reduction=reduction))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gain_layer_norm_matches_jax(dtype):
    r = np.random.RandomState(1)
    x = (2 * r.randn(3, 5, 16) + 0.5).astype(np.float32)
    g = (1 + 0.3 * r.randn(16)).astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    want = JGainLayerNorm(16).apply({"params": {"g": jnp.asarray(g)}}, jx)
    layer = GainLayerNorm(16)
    layer.g.data = torch.from_numpy(g)
    got = layer(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    atol = 1e-6 if dtype == "float32" else 2.0 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# --- the linattn variant ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def linattn_pair():
    cfg = tiny_cfg()
    jmodel = jax_build_model("DrugLAMPwoLLM", cfg, ND, NP, pmma_variant="linattn")
    params, stats = jax_variables(jmodel, cfg)
    pmodel = port_build_model("DrugLAMPwoLLM", port_config(cfg), ND, NP, pmma_variant="linattn")
    pmodel.load_state_dict(from_jax_params(params, stats, pmodel))
    b = jsyn.make_batch(cfg, 4, seed=5, n_drug_feature=ND, n_prot_feature=NP)
    return jmodel, params, stats, pmodel, b


def test_linattn_variant_forward_matches_jax(linattn_pair):
    jmodel, params, stats, pmodel, b = linattn_pair
    assert "lin1" in params["pmma"]["block_2"]
    assert hasattr(pmodel.pmma.block_2, "lin1") and hasattr(pmodel.pmma.block_1, "attn")
    want = jmodel.apply({"params": params, "batch_stats": stats}, jax.tree.map(jnp.asarray, b),
                        train=False)["score"]
    with torch.no_grad():
        got = pmodel.eval()(to_torch(b))["score"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_linattn_variant_gradients_match_jax(linattn_pair):
    jmodel, params, stats, pmodel, b = linattn_pair
    jb = jax.tree.map(jnp.asarray, b)

    @jax.jit
    def grads(p):
        def loss(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": stats}, jb, train=True,
                                  rngs={"dropout": jax.random.key(9)}, mutable=["batch_stats"])
            return jbce(out["score"], jb["labels"])[1]
        return jax.value_and_grad(loss)(p)

    jloss, jgrads = grads(params)
    want = {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(jgrads).items()}
    pmodel.train()
    with psteps.train_numerics():
        cls, *_, g = psteps.loss_gradients(pmodel, decode_batch(to_torch(b)), None, False, False,
                                           False, 0.5, torch.ones(()))
    assert float(cls) == pytest.approx(float(jloss), abs=1e-5)
    names = [n for n, _ in pmodel.named_parameters()]
    got = to_jax_paths(dict(zip(names, g["cls"])), pmodel)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=5e-3, atol=5e-5, err_msg=k)


# --- partition, inspect, protein features -------------------------------------------------------

@pytest.mark.parametrize("kind", ["drug", "pair"])
def test_partition_data_matches_jax(kind):
    ids = [f"D{i % 13}" for i in range(50)]
    got = ppartition([0.7, 0.1, 0.2], ids, kind=kind, seed=3)
    want = jpartition([0.7, 0.1, 0.2], ids, kind=kind, seed=3)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a["drugs"] == b["drugs"] and [int(i) for i in a["ids"]] == [int(i) for i in b["ids"]]


@pytest.mark.parametrize("query,label", [("CCO", "drug"), ("C1=CC=CC=C1", "drug"),
                                         ("CCCCCCCCC", "drug"),
                                         ("MSEQNNTEMTFQIQRIYTKDIS", "prot"), ("MAAA", "prot")])
def test_find_in_train_set_matches_jax(tmp_path, query, label):
    from tests.test_train import _make_csv_dataset

    root = _make_csv_dataset(tmp_path)
    assert pfind(query, root, "toy", "random", label) == jfind(query, root, "toy", "random",
                                                               label)


def test_protein_features_match_jax():
    seq = "MKTAYIAKQRQISFVKSHFSRQLEBZJX"
    aln = [seq, "MKTAYIAKQRQISFVKSHFARQLEBZJX", "short", "AKTAYIAKQRQISFVKSHFSRQLEBZGX"]
    assert np.array_equal(ppf.seq_feature(seq), jpf.seq_feature(seq))
    assert np.array_equal(ppf.prot_feature(aln, seq), jpf.prot_feature(aln, seq))
    assert ppf.prot_feature(aln, seq).shape == (len(seq), 21 + 33)


# The fit tests' LR (tests/test_torch_port_trainer.py): an AdamW update turns
# a gradient at rounding-noise level into a ±lr step in either package, so
# later losses drift apart in proportion to lr.
LR = 1e-5


# --- Trainer.fast_dev_run -------------------------------------------------------------------------

def test_fast_dev_run_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jssl, "mlm_mask", _jax_fixed_mask)
    monkeypatch.setattr(pmask, "mlm_mask", _port_fixed_mask)
    cfg = tiny_config(n_hidden=16, max_nodes=32, site_seq=16, pmma_dropout=0.0,
                      solver=JSolverConfig(compute_dtype="float32", batch_size=4,
                                           eval_batch_size=4, lr=LR, ssl_lr=LR, cm_lr=LR),
                      rs=JRSConfig(ssl=True, cm=True))
    pcfg = _full_port_config(cfg)
    root = _toy_dataset(str(tmp_path / "data"))
    jmodel = jax_build_model("DrugLAMP2C2P", cfg, ND, NP)
    params, stats = jax_variables(jmodel, cfg)
    kw = dict(max_nodes=cfg.drug.max_nodes, seq_len=cfg.protein.seq_len,
              max_prot_resis=cfg.protein.max_resis)

    def loaders(ds_cls, loader_cls, emb, **lkw):
        train = ds_cls(root, "toy", "random", "train.csv", **kw)
        val = ds_cls(root, "toy", "random", "val.csv", table=train.table, **kw)
        return [loader_cls(ds, 4, shuffle=sh, drop_last=sh, seed=3, embeddings=emb,
                           prefetch=0, **lkw) for ds, sh in ((train, True), (val, False),
                                                             (val, False))]

    def jax_init(self, example_batch, seed):
        return JTrainState.create({"params": jax.tree.map(jnp.array, params),
                                   "batch_stats": jax.tree.map(jnp.array, stats)}, True, True)

    monkeypatch.setattr(JTrainer, "init_state", jax_init)
    table = DTIDataset(root, "toy", "random", "train.csv", **kw).table
    cache = _seed_cache(str(tmp_path / "cache"), table, pcfg)
    jt = JTrainer(jmodel, cfg, *loaders(JDataset, JBatchLoader, JCache(cache, "toy", ND, NP),
                                        compact=True), work_dir=str(tmp_path / "jax"))
    want = jt.fast_dev_run(None, seed=0, n_batches=3)

    pmodel = port_build_model("DrugLAMP2C2P", pcfg, ND, NP)
    state = from_jax_params(params, stats, pmodel)

    def port_init(self, seed):
        self.model.load_state_dict(state)
        return TrainState.create(self.model, self.use_ssl, self.use_cm)

    monkeypatch.setattr(Trainer, "init_state", port_init)
    pt = Trainer(pmodel, pcfg, *loaders(DTIDataset, BatchLoader, EmbeddingCache(cache, "toy",
                                                                                ND, NP)),
                 work_dir=str(tmp_path / "port"), device="cpu")
    got = pt.fast_dev_run(seed=0, n_batches=3)
    assert len(got["train_losses"]) == 3 and got.keys() == want.keys()
    np.testing.assert_allclose(got["train_losses"], want["train_losses"], rtol=0, atol=1e-5)
    for k in ("val_auroc", "val_auprc", "val_loss"):
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    assert not list((tmp_path / "port").iterdir())          # no checkpoint
