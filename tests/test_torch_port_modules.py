"""Each module of the port that reaches an attention core or carries the
model's subtle conventions, held against its JAX counterpart: the same numpy
inputs, the JAX weights (perturbed, so zero-initialized terms take part)
carried over by ``convert.from_jax_params``, eval BatchNorm with random running
stats, fp32, 2e-5 abs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from druglamp_tpu.nn.gca import GuidedCrossAttention as JGCA
from druglamp_tpu.nn.gcn import MolecularGCN as JGCN
from druglamp_tpu.nn.mhla import MultiHeadLinearAttention as JMHLA
from druglamp_tpu.nn.pmma import PairedMultimodalAttention as JPMMA
from druglamp_tpu.nn.protein_cnn import ProteinCNN as JCNN
from druglamp_tpu.utils.synthetic import make_batch
from druglamp_tpu_torch.convert import from_jax_params
from druglamp_tpu_torch.nn.gca import GuidedCrossAttention
from druglamp_tpu_torch.nn.gcn import MolecularGCN
from druglamp_tpu_torch.nn.layers import Dense
from druglamp_tpu_torch.nn.mhla import MultiHeadLinearAttention
from druglamp_tpu_torch.nn.pmma import PairedMultimodalAttention
from druglamp_tpu_torch.nn.protein_cnn import ProteinCNN
from tests.torch_port_util import perturb, random_stats, tiny_cfg

ATOL = 2e-5


def _carry(jmodule, tmodule, args, seed=0, train_args=None):
    """Init the flax module on ``args``, perturb its params, randomize its BN
    stats, load them into the torch module → (variables, torch module)."""
    variables = jmodule.init(jax.random.key(seed), *map(jnp.asarray, args), **(train_args or {}))
    rng = np.random.RandomState(seed)
    params = perturb(variables["params"], rng)
    stats = random_stats(variables.get("batch_stats", {}), rng)
    tmodule.load_state_dict(from_jax_params(params, stats, tmodule))
    return {"params": params, "batch_stats": stats}, tmodule.eval()


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def graph_batch():
    b = make_batch(tiny_cfg(), 3, seed=5, n_drug_feature=8, n_prot_feature=8)
    return b["drug_node_feats"], b["drug_adj"], b["drug_degrees"]


def test_gcn_dense_path(graph_batch):
    nf, adj, deg = graph_batch
    jm = JGCN(in_feats=75, dim_embedding=16, hidden_feats=(16, 16, 16))
    variables, tm = _carry(jm, MolecularGCN(75, 16, (16, 16, 16)), (nf, adj, deg))
    ref = jm.apply(variables, *map(jnp.asarray, (nf, adj, deg)), train=False)
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (nf, adj, deg)))
    _close(out, ref)


def test_gcn_train_mode_batchnorm(graph_batch):
    """Train-mode BatchNorm normalizes with the biased batch variance and
    updates the running stats as flax does."""
    nf, adj, deg = graph_batch
    jm = JGCN(in_feats=75, dim_embedding=16, hidden_feats=(16, 16, 16))
    variables, tm = _carry(jm, MolecularGCN(75, 16, (16, 16, 16)), (nf, adj, deg), seed=1)
    ref, muts = jm.apply(variables, *map(jnp.asarray, (nf, adj, deg)), train=True,
                         mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (nf, adj, deg)))
    _close(out, ref)
    for i in range(3):
        new = muts["batch_stats"][f"layer_{i}"]["bn"]["BatchNorm_0"]
        bn = getattr(tm, f"layer_{i}").bn
        _close(bn.running_mean, new["mean"])
        _close(bn.running_var, new["var"])


def test_protein_cnn_same_padding_with_k6():
    B, L = 2, 60
    r = np.random.RandomState(3)
    v = r.randint(0, 27, (B, L)).astype(np.int32)
    v[:, :4] = 0                                        # pad ids: zero rows
    fill = (r.rand(B, L) > 0.7).astype(np.float32)
    jm = JCNN(embedding_dim=16, num_filters=(16, 16, 16), kernel_size=(3, 6, 9))
    variables, tm = _carry(jm, ProteinCNN(16, (16, 16, 16), (3, 6, 9)), (v, fill))
    ref = jm.apply(variables, jnp.asarray(v), jnp.asarray(fill), train=False)
    with torch.no_grad():
        out = tm(torch.from_numpy(v), torch.from_numpy(fill))
    assert out.shape == (B, L, 16)
    _close(out, ref)


def test_gca_output_and_raw_logits():
    B, L, S, E = 2, 12, 20, 16
    r = np.random.RandomState(4)
    q, kv = r.randn(B, L, E).astype(np.float32), r.randn(B, S, E).astype(np.float32)
    jm = JGCA(embed_dim=E, num_heads=1)
    variables, tm = _carry(jm, GuidedCrossAttention(E, 1), (q, kv, kv))
    ref, ref_raw = jm.apply(variables, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                            need_raw=True)
    with torch.no_grad():
        out, raw = tm(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv))
        _, none = tm(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
                     need_raw=False)
    assert raw.shape == (B, 1, L, S) and none is None
    _close(out, ref)
    _close(raw, ref_raw)


def test_mhla_raw_view_gating():
    B, L, E = 2, 12, 32
    v = np.random.RandomState(5).randn(B, L, E).astype(np.float32)
    jm = JMHLA(d_model=E, nhead=8, d_diff=64, dropout=0.0, activation="gelu")
    variables, tm = _carry(jm, MultiHeadLinearAttention(E, 8, 64, 0.0, "gelu"), (v,))
    ref = jm.apply(variables, jnp.asarray(v))
    with torch.no_grad():
        out = tm(torch.from_numpy(v))
    _close(out, ref)


def test_pmma_argument_order():
    """pmma(prot, mol): the port matches JAX in the same order and visibly
    differs from the swapped one (the LLM stream is PMMA's "prot" input)."""
    B, L, E = 2, 16, 32
    r = np.random.RandomState(6)
    prot, mol = r.randn(B, L, E).astype(np.float32), r.randn(B, L, E).astype(np.float32)
    jm = JPMMA(hidden_size=E, num_heads=4, num_layers=4, feat_len=L, mol_len=L, dropout_rate=0.0)
    variables, tm = _carry(jm, PairedMultimodalAttention(E, 4, 4, L, L, 0.0), (prot, mol))
    ref = jm.apply(variables, jnp.asarray(prot), jnp.asarray(mol))[0]
    swapped = jm.apply(variables, jnp.asarray(mol), jnp.asarray(prot))[0]
    with torch.no_grad():
        out = tm(torch.from_numpy(prot), torch.from_numpy(mol))[0]
    assert out.shape == (B, L, 2 * E)
    _close(out, ref)
    assert np.abs(np.asarray(swapped) - out.numpy()).max() > 1e-2


def test_pmma_attention_maps_with_vis():
    B, L, E = 1, 16, 32
    r = np.random.RandomState(7)
    prot, mol = r.randn(B, L, E).astype(np.float32), r.randn(B, L, E).astype(np.float32)
    jm = JPMMA(hidden_size=E, num_heads=4, feat_len=L, mol_len=L, dropout_rate=0.0, vis=True)
    variables, tm = _carry(jm, PairedMultimodalAttention(E, 4, 4, L, L, 0.0, vis=True), (prot, mol))
    _, jw, jgw = jm.apply(variables, jnp.asarray(prot), jnp.asarray(mol))
    with torch.no_grad():
        _, w, gw = tm(torch.from_numpy(prot), torch.from_numpy(mol))
    assert len(w) == len(gw) == 4 and gw[2] is None
    for a, b in zip(w + gw[:2], jw + jgw[:2]):
        assert a.shape == (B, 4, L, L)
        _close(a, b)


@pytest.mark.parametrize("x_dtype,dense_dtype,want", [
    (torch.bfloat16, None, torch.float32),        # promotes, as jnp.dot does
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.float32, None, torch.float32),
])
def test_dense_dtype_rule(x_dtype, dense_dtype, want):
    from druglamp_tpu.nn.layers import TorchDense

    jdt = {None: None, torch.bfloat16: jnp.bfloat16}[dense_dtype]
    x = np.random.RandomState(8).randn(3, 8).astype(np.float32)
    jx = jnp.asarray(x, {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[x_dtype])
    jm = TorchDense(4, dtype=jdt)
    variables = jm.init(jax.random.key(0), jx)
    tm = Dense(8, 4, dtype=dense_dtype)
    state = from_jax_params(variables["params"], {}, tm)
    tm.load_state_dict(state)
    ref = jm.apply(variables, jx)
    out = tm(torch.from_numpy(x).to(x_dtype))
    assert out.dtype == want and str(ref.dtype) == str(want).split(".")[-1]
    np.testing.assert_allclose(out.float().detach().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)
