"""The port's cls-gate training step (druglamp_tpu_torch/train/) against the
JAX package's, on the CPU at fp32 and a tiny configuration: the same flax
trees carried over by the weight bridge, the same compact batch, dropout 0.
Also the eval step, the AdamW update, the copies of the batch encoding and
the synthetic batch, dropout in train mode, and what the slice refuses.

Tolerances (docs/PARITY.md): per-loss values 1e-5; gradients rtol 5e-3 /
atol 5e-5; BatchNorm running stats 2e-5; AdamW over 20 steps rtol 1e-5 /
atol 1e-7.  After 3 steps at lr 1e-4 every parameter lies within 6·lr (a
sign flip of a near-zero gradient moves Adam's update by up to 2·lr a step)
and 99% of entries within 1e-6.  Every leaf is compared, the SSL and CM
heads' included (the cls step only decays them, in both packages).  The
SSL and CM gates are held in tests/test_torch_port_ssl_cm.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import druglamp_tpu.data.encoding as jenc
import druglamp_tpu.utils.synthetic as jsyn
from druglamp_tpu.losses.classification import binary_cross_entropy as jbce
from druglamp_tpu.train.state import TrainState as JTrainState
from druglamp_tpu.train.state import apply_optimizer as japply, make_adamw_tx
from druglamp_tpu.train.steps import make_eval_step as jmake_eval_step
from druglamp_tpu.train.steps import make_train_step as jmake_train_step
from druglamp_tpu_torch.convert import to_jax_paths
from druglamp_tpu_torch.data import encoding as penc
from druglamp_tpu_torch.losses.classification import cross_entropy_logits
from druglamp_tpu_torch.models.registry import build_model as port_build_model
from druglamp_tpu_torch.nn.layers import dropout
from druglamp_tpu_torch.train.state import TrainState, apply_optimizer, make_adamw
from druglamp_tpu_torch.train.steps import make_eval_step, make_train_step
from druglamp_tpu_torch.utils import synthetic as psyn
from tests.torch_port_util import ND, NP, build_pair, port_config, tiny_cfg, to_torch

LR = 1e-4
STEPS = 3
VARIANTS = ["DrugLAMP", "DrugLAMPwoLLM"]


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


def _compact(cfg, B=4, seed=3):
    b = jsyn.make_batch(cfg, B, seed=seed, n_drug_feature=ND, n_prot_feature=NP)
    return jenc.compact_batch(b, (b["d_fill"] == 0).sum(1))


@pytest.fixture(scope="module", params=VARIANTS)
def trajectories(request):
    """Both steps from the same trees on the same compact batch: the JAX
    step's outputs, its step-1 gradients, and the port's after each step."""
    name = request.param
    cfg = tiny_cfg()
    jmodel, params, stats, pmodel = build_pair(name, cfg)
    batch = _compact(cfg)

    jbatch = jax.tree.map(jnp.asarray, batch)
    decoded = jenc.decode_batch(jbatch)

    @jax.jit
    def jgrads(p):
        def loss(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": stats}, decoded, train=True,
                                  rngs={"dropout": jax.random.key(9)}, mutable=["batch_stats"])
            return jbce(out["score"], decoded["labels"])[1]
        return jax.grad(loss)(p)

    j = {"grads": _flat(jgrads(params)), "loss": [], "probs": [], "state": []}
    state = JTrainState.create({"params": jax.tree.map(jnp.array, params),
                                "batch_stats": jax.tree.map(jnp.array, stats)},
                               use_ssl=False, use_cm=False)
    step = jmake_train_step(jmodel, False, False)
    for i in range(STEPS):
        out = step(state, jbatch, jax.random.key(i), jnp.float32(LR), jnp.float32(0.0),
                   jnp.float32(0.0), jnp.float32(0.5), jnp.float32(1.0))
        state = out.state
        j["loss"].append(float(out.cls_loss))
        j["probs"].append(np.asarray(out.probs))
        j["state"].append({**_flat(state.params), **_flat(state.batch_stats)})

    p = {"loss": [], "probs": [], "state": []}
    pstate = TrainState.create(pmodel)
    pstep = make_train_step(pmodel, False, False, device="cpu")
    tbatch = to_torch(batch)
    for i in range(STEPS):
        out = pstep(pstate, tbatch, torch.Generator().manual_seed(i), LR)
        if i == 0:
            p["grads"] = to_jax_paths({n: q.grad for n, q in pmodel.named_parameters()}, pmodel)
        p["loss"].append(float(out.cls_loss))
        p["probs"].append(out.probs.numpy())
        p["state"].append(to_jax_paths(pmodel.state_dict(), pmodel))
    assert pstate.step == STEPS and float(out.ssl_loss) == float(out.cm_loss) == 0.0
    return j, p


def test_cls_loss_and_probabilities(trajectories):
    """Losses of every step within 1e-5; the probabilities of the first step
    within 1e-5 (later ones move with the sign-flip drift of the parameters)."""
    j, p = trajectories
    for i in range(STEPS):
        assert abs(j["loss"][i] - p["loss"][i]) < 1e-5, i
    np.testing.assert_allclose(p["probs"][0], j["probs"][0], rtol=0, atol=1e-5)


def test_gradients_leaf_by_leaf(trajectories):
    j, p = trajectories
    assert set(p["grads"]) == set(j["grads"])
    for key, ref in j["grads"].items():
        np.testing.assert_allclose(p["grads"][key], ref, rtol=5e-3, atol=5e-5, err_msg=key)


def test_batchnorm_running_stats_after_the_step(trajectories):
    j, p = trajectories
    stats = [k for k in j["state"][0] if k.endswith(("/mean", "/var"))]
    assert stats
    for key in stats:
        np.testing.assert_allclose(p["state"][0][key], j["state"][0][key], rtol=0, atol=2e-5,
                                   err_msg=key)


def test_parameters_after_three_steps(trajectories):
    j, p = trajectories
    ref, got = j["state"][-1], p["state"][-1]
    assert set(got) == set(ref)
    diffs = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert diffs.max() <= 6 * LR, diffs.max()
    assert np.mean(diffs <= 1e-6) >= 0.99, np.mean(diffs <= 1e-6)


def test_eval_step_matches():
    cfg = tiny_cfg()
    jmodel, params, stats, pmodel = build_pair("DrugLAMP", cfg, seed=2)
    batch = _compact(cfg, B=5, seed=4)
    batch["valid"] = np.array([1, 1, 0, 1, 0], np.float32)
    jprobs, jloss = jmake_eval_step(jmodel)(params, stats, jax.tree.map(jnp.asarray, batch))
    probs, loss = make_eval_step(pmodel, device="cpu")(batch)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-5)
    assert abs(float(loss) - float(jloss)) < 1e-5


def test_adamw_matches_apply_optimizer():
    """20 steps with identical gradients and a changing LR; ``c`` never gets
    a gradient in the port (None) and a zero one in JAX, and still decays."""
    r = np.random.RandomState(0)
    params = {"a": r.randn(4, 3).astype(np.float32), "b": r.randn(7).astype(np.float32),
              "c": r.randn(5).astype(np.float32)}
    pj = jax.tree.map(jnp.asarray, params)
    opt_j = make_adamw_tx().init(pj)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt_t = make_adamw(pt.values())
    for step in range(20):
        lr = 1e-3 * (0.8 ** step)
        g = {k: (r.randn(*v.shape).astype(np.float32) * 10.0 ** r.randint(-6, 1)
                 if k != "c" else np.zeros_like(v)) for k, v in params.items()}
        pj, opt_j = japply(opt_j, jax.tree.map(jnp.asarray, g), pj, lr)
        for k in ("a", "b"):
            pt[k].grad = torch.from_numpy(g[k])
        pt["c"].grad = None
        apply_optimizer(opt_t, lr)
    for k in params:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert np.abs(pt["c"].detach().numpy() - params["c"]).max() > 0


@pytest.mark.parametrize("n_class", [1, 2])
def test_cls_losses_match(n_class):
    from druglamp_tpu.losses.classification import cross_entropy_logits as jce
    from druglamp_tpu_torch.losses.classification import binary_cross_entropy

    r = np.random.RandomState(n_class)
    scores = (3 * r.randn(8, n_class)).astype(np.float32)
    labels = r.randint(0, 2, size=8).astype(np.float32)
    ref = (jbce if n_class == 1 else jce)(jnp.asarray(scores), jnp.asarray(labels))
    got = (binary_cross_entropy if n_class == 1 else cross_entropy_logits)(
        torch.from_numpy(scores), torch.from_numpy(labels))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


# --- copies of the batch encoding and the synthetic batch ----------------------------

@pytest.mark.parametrize("seed,B", [(0, 4), (7, 3)])
def test_host_copies_are_bit_identical(seed, B):
    jb = jsyn.make_batch(tiny_cfg(), B, seed=seed, n_drug_feature=ND, n_prot_feature=NP)
    pb = psyn.make_batch(port_config(tiny_cfg()), B, seed=seed, n_drug_feature=ND,
                         n_prot_feature=NP)
    assert port_config(jsyn.tiny_config()) == psyn.tiny_config()
    n_atoms = (jb["d_fill"] == 0).sum(1)
    jc, pc = jenc.compact_batch(jb, n_atoms), penc.compact_batch(pb, n_atoms)
    for ref, got in ((jb, pb), (jc, pc)):
        assert set(ref) == set(got)
        for k in ref:
            assert ref[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(penc.unpack_adjacency_np(pc["drug_adj_packed"]),
                                  jenc.unpack_adjacency_np(jc["drug_adj_packed"]))
    np.testing.assert_array_equal(
        penc.unpack_node_feats_np(pc["drug_node_bits"], pc["drug_node_ints"]),
        jenc.unpack_node_feats_np(jc["drug_node_bits"], jc["drug_node_ints"]))


@pytest.mark.parametrize("form", ["packed_bits", "int8_feats", "xp_src", "standard"])
def test_decode_batch_matches(form):
    cfg = tiny_cfg()
    b = jsyn.make_batch(cfg, 3, seed=5, n_drug_feature=ND, n_prot_feature=NP)
    batch = jenc.compact_batch(b, (b["d_fill"] == 0).sum(1))
    if form == "int8_feats":
        del batch["drug_node_bits"], batch["drug_node_ints"]
        batch["drug_node_feats"] = b["drug_node_feats"].astype(np.int8)
    elif form == "xp_src":
        r = np.random.RandomState(6)
        del batch["xp"]
        batch["xp_src"] = r.rand(3, 40, NP).astype(np.float32)
        batch["xp_len"] = np.array([40, 13, 0], np.int32)
    elif form == "standard":
        batch = b
    ref = jenc.decode_batch(jax.tree.map(jnp.asarray, batch), keep_packed=False)
    got = penc.decode_batch(to_torch(batch))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == tuple(ref[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
        assert str(got[k].dtype).split(".")[-1] == str(ref[k].dtype), k


# --- dropout ------------------------------------------------------------------------------

def test_dropout_rate_and_scale():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(1_000_000)
    y = dropout(x, 0.1, True, g)
    dropped = float((y == 0).float().mean())
    assert abs(dropped - 0.1) <= 3 * np.sqrt(0.1 * 0.9 / x.numel())
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert dropout(x, 0.1, False, g) is x


def test_dropout_step_is_reproducible_from_its_seed():
    """Dropout 0.1 in PMMA: two runs from one generator seed give bit-identical
    losses and parameters; another seed gives another trajectory."""
    cfg = port_config(jsyn.tiny_config(n_hidden=16, max_nodes=32, site_seq=16,
                                       pmma_dropout=0.1))
    host = psyn.make_batch(cfg, 4, seed=1, n_drug_feature=ND, n_prot_feature=NP)
    batch = to_torch(penc.compact_batch(host, (host["d_fill"] == 0).sum(1)))

    def run(seed):
        model = port_build_model("DrugLAMP", cfg, ND, NP, generator=torch.Generator().manual_seed(0))
        step, state = make_train_step(model, False, False, device="cpu"), TrainState.create(model)
        g = torch.Generator().manual_seed(seed)
        losses = [float(step(state, batch, g, 1e-3).cls_loss) for _ in range(2)]
        return losses, [p.detach().clone() for p in model.parameters()]

    (l1, p1), (l2, p2), (l3, _) = run(5), run(5), run(6)
    assert l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert l3 != l1


# --- what the slice refuses ------------------------------------------------------------

@pytest.mark.parametrize("case", ["grouped_ssl_bn", "grouped_cm", "grouped_cm_batches",
                                  "grouped_masked_bn", "grad_mode"])
def test_refuses_what_later_slices_port(case):
    """The gates themselves are ported (tests/test_torch_port_ssl_cm.py); what
    stays refused: their per-replica BatchNorm and CM mining (groups > 1, the
    multi-GPU slice), also in the host batches' CM ground truth
    (``BatchLoader(cm_groups=2)``), and an unknown grad mode."""
    from druglamp_tpu_torch.data.loader import BatchLoader
    from druglamp_tpu_torch.models.cm import CrossModality
    from druglamp_tpu_torch.models.ssl import SSL
    from druglamp_tpu_torch.nn.layers import MaskedBatchNorm
    from druglamp_tpu_torch.nn.protein_cnn import ProteinCNN

    cfg = tiny_cfg()
    model = port_build_model("DrugLAMPwoLLM", port_config(cfg), ND, NP)
    err = ValueError if case == "grad_mode" else NotImplementedError
    with pytest.raises(err):
        if case == "grouped_ssl_bn":
            SSL(ProteinCNN(16, (16,) * 3), NP, ND, n_hidden=16, bn_groups=2)
        elif case == "grouped_cm":
            CrossModality(16, groups=2)
        elif case == "grouped_cm_batches":
            BatchLoader(None, 4, True, True, cm_groups=2)
        elif case == "grouped_masked_bn":
            MaskedBatchNorm(16, groups=2)
        else:
            make_train_step(model, False, False, grad_mode="summed", device="cpu")


@pytest.mark.parametrize("grad_mode", ["per_loss", "legacy_aliased"])
def test_both_grad_modes_give_the_cls_step(grad_mode):
    cfg = tiny_cfg()
    batch = to_torch(_compact(cfg, B=2))
    losses = []
    for _ in range(2):
        model = port_build_model("DrugLAMPwoLLM", port_config(cfg), ND, NP,
                                 generator=torch.Generator().manual_seed(0))
        step = make_train_step(model, False, False, device="cpu",
                               grad_mode=grad_mode if not losses else "per_loss")
        state = TrainState.create(model)
        losses.append([float(step(state, batch, None, 1e-3).cls_loss) for _ in range(2)])
    assert losses[0] == losses[1]
