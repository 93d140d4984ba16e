"""The SSL and CM gates of the port (druglamp_tpu_torch/: nn/layers.py's
affine-free and masked BatchNorm, losses/masking.py, losses/schedules.py,
train/schedule.py, models/ssl.py, models/cm.py, the heads in the models, the
weight bridge, and the three-AdamW step with every gate) against the JAX
package, on the CPU at fp32 and a tiny configuration, weights carried over by
``convert.from_jax_params``.

Tolerances: the BatchNorm layers (output and running stats) and the loss
functions 1e-6; the SSL head in its three modes and the CM head 1e-5 (loss
and running stats); the schedules, the LR and the calibration bit-identical.
The step: per-loss values 1e-5; each loss's gradient rtol 5e-3 / atol 5e-5
(docs/PARITY.md); BatchNorm running stats 1e-5; the CM weight exact; the
parameters after the three AdamWs rtol 1e-5 / atol 1e-7 against the JAX
package's optimizers applied to the port's own gradients.  (Against JAX's
gradients that tolerance cannot hold everywhere: an AdamW's first update is
lr·g/(|g| + 1e-8), and where the exact gradient is 0, as for the PMMA key
biases that softmax ignores, both packages' gradients are f32 rounding noise
whose sign and size set the update; so the gradients are held by their own
tolerance, and the optimizers by this one.)

The two frameworks draw different MLM masks, so the sampler is held to its
invariants, and the parity tests inject one fixed mask into both packages
(every 5th non-pad position, as ``tools/two_framework_train.py`` does).

The JAX step compiles for tens of seconds per gate combination, so one JAX
program per model computes the per-loss values, gradients and running stats
of the shared forward, and runs the JAX step itself on the full gate
(ssl + cm + calibrate, per_loss); the other combinations compose the JAX
package's own ``_calibrate`` and ``apply_optimizer`` on those gradients as
``_make_step_body`` composes them, and that composition is held to the JAX
step on the full gate first."""

import copy
import functools
import math

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
from druglamp_tpu.losses import masking as jmask
from druglamp_tpu.losses.classification import binary_cross_entropy as jbce
from druglamp_tpu.losses.schedules import MarginSchedule as JMarginSchedule
from druglamp_tpu.models import cm as jcm
from druglamp_tpu.nn.layers import MaskedBatchNorm as JMaskedBatchNorm
from druglamp_tpu.nn.layers import TorchBatchNorm as JTorchBatchNorm
from druglamp_tpu.train import steps as jsteps
from druglamp_tpu.train.schedule import cosine_warmup_restarts_lr as jlr
from druglamp_tpu.train.state import TrainState as JTrainState
from druglamp_tpu.train.state import apply_optimizer as japply
from druglamp_tpu_torch.convert import from_jax_params, to_jax_paths
from druglamp_tpu_torch.data import encoding as penc
from druglamp_tpu_torch.losses import masking as pmask
from druglamp_tpu_torch.losses.schedules import MarginSchedule
from druglamp_tpu_torch.models import cm as pcm
from druglamp_tpu_torch.models import ssl as pssl
from druglamp_tpu_torch.models.registry import build_model as port_build_model
from druglamp_tpu_torch.nn.layers import MaskedBatchNorm, TorchBatchNorm
from druglamp_tpu_torch.train import steps as psteps
from druglamp_tpu_torch.train.schedule import cosine_warmup_restarts_lr
from druglamp_tpu_torch.train.state import TrainState
from tests.torch_port_ranks import fixed_mask as _port_fixed_mask
from tests.torch_port_util import (ND, NP, build_pair, port_config, random_stats, tiny_cfg,
                                   to_torch)
from tools.two_framework_train import _torch_calibrate

LR, LR_SSL, LR_CM, MARGIN, CM_W0 = 1e-4, 3e-5, 3e-5, 0.5, 1e-3
ADAM_NOISE = 1e-7          # |g| below which an AdamW first update is rounding noise
MAX_NOISY = 0.02           # the share of entries the JAX step may leave that noisy
B = 6
# protein / drug ordinals of the step's batch: protein 0 and 1 have a positive
# and a negative, protein 2 negatives only (the fallback branch)
PIDS, DIDS = np.array([0, 1, 0, 2, 1, 2]), np.array([0, 0, 1, 2, 3, 1])
LABELS = np.array([1, 0, 0, 0, 1, 0], np.float32)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


# --- the fixed MLM mask, injected into both packages --------------------------------

def _jax_fixed_mask(seq, rng, **kw):
    idx = jnp.arange(seq.shape[1])[None, :]
    mask = (seq != 0) & (idx % 5 == 0)
    return jnp.where(mask, 26, seq), jnp.where(mask, seq, 0), mask


@pytest.fixture
def fixed_mask(monkeypatch):
    monkeypatch.setattr(jssl, "mlm_mask", _jax_fixed_mask)
    monkeypatch.setattr(pmask, "mlm_mask", _port_fixed_mask)


# --- BatchNorm layers -----------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_affine_free_batchnorm_matches_flax(train):
    r = np.random.RandomState(0)
    x = (1.5 * r.randn(40, 12) + 0.3).astype(np.float32)
    jmod = JTorchBatchNorm(affine=False)
    v = jmod.init(jax.random.key(0), jnp.asarray(x), use_running_average=False)
    stats = {"BatchNorm_0": {"mean": r.randn(12).astype(np.float32),
                             "var": r.uniform(0.5, 2, 12).astype(np.float32)}}
    ref, muts = jmod.apply({"batch_stats": stats}, jnp.asarray(x), use_running_average=not train,
                           mutable=["batch_stats"])
    assert "params" not in v
    port = TorchBatchNorm(12, affine=False).train(train)
    assert not list(port.parameters())
    port.running_mean.copy_(torch.from_numpy(stats["BatchNorm_0"]["mean"]))
    port.running_var.copy_(torch.from_numpy(stats["BatchNorm_0"]["var"]))
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    new = muts["batch_stats"]["BatchNorm_0"] if train else stats["BatchNorm_0"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(new["mean"]), atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(new["var"]), atol=1e-6)


@pytest.mark.parametrize("case", ["train", "eval", "one_valid", "none_valid"])
def test_masked_batchnorm_matches_jax(case):
    """Statistics over the valid rows only (the invalid rows hold large
    values that would show); the running stats with the unbiased variance.
    Outputs 1e-6 on the valid rows, relative 1e-6 on the shifted invalid
    rows (|y| up to ~70)."""
    r = np.random.RandomState(1)
    x = r.randn(8, 10).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 0], bool)
    if case == "one_valid":
        mask = np.eye(8, dtype=bool)[3]
    elif case == "none_valid":
        mask = np.zeros(8, bool)
    x[~mask] += 50.0
    jmod = JMaskedBatchNorm()
    v = jmod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask))
    params = {"scale": r.uniform(0.5, 1.5, 10).astype(np.float32),
              "bias": r.randn(10).astype(np.float32)}
    stats = {"mean": r.randn(10).astype(np.float32),
             "var": r.uniform(0.5, 2, 10).astype(np.float32)}
    train = case != "eval"
    ref, muts = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                           jnp.asarray(mask), use_running_average=not train,
                           mutable=["batch_stats"])
    port = MaskedBatchNorm(10).train(train)
    port.load_state_dict(from_jax_params(params, stats, port))
    assert set(_flat(v["params"])) == set(params)
    got = port(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(got[mask], ref[mask], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[~mask], ref[~mask], rtol=1e-6, atol=1e-6)
    new = muts["batch_stats"] if train else stats
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(new["mean"]), atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(new["var"]), atol=1e-6)


def _grouped_layers(layer):
    """(JAX module, port module, the port's groups=1 twin, inputs) of one
    layer with per-replica
    statistics over 2 groups; the batch's halves differ in distribution."""
    r = np.random.RandomState(11)
    if layer == "batchnorm":
        x = r.randn(8, 5, 12).astype(np.float32)
        x[4:] = 3.0 * x[4:] + 2.0
        return JTorchBatchNorm(groups=2), TorchBatchNorm(12, groups=2), TorchBatchNorm(12), (x,)
    if layer == "masked":
        x = r.randn(8, 10).astype(np.float32)
        x[4:] += 4.0
        mask = np.array([1, 1, 0, 1, 0, 1, 1, 1], bool)
        return (JMaskedBatchNorm(groups=2), MaskedBatchNorm(10, groups=2), MaskedBatchNorm(10),
                (x, mask))
    if layer == "simsiam":
        x = r.randn(8, 8).astype(np.float32)
        x[4:] -= 1.5
        return (jssl.SimSiamMLP(8, hidden_size=16, bn_groups=2),
                pssl.SimSiamMLP(8, 8, hidden_size=16, bn_groups=2),
                pssl.SimSiamMLP(8, 8, hidden_size=16), (x,))
    xs = [r.randn(B, 5, 8).astype(np.float32) for _ in range(4)]
    halves = [build_cm_arrays(PIDS[s], DIDS[s], LABELS[s]) for s in (slice(0, 3), slice(3, 6))]
    cm = {k: np.stack([h[k] for h in halves]) for k in halves[0]}
    args = [cm[k] for k in ("p_index", "p_valid", "d_index", "d_valid", "gt")]
    return (jcm.CrossModality(hidden_size=8, groups=2), pcm.CrossModality(8, groups=2),
            pcm.CrossModality(8), (*xs, *args, np.float32(MARGIN)))


@pytest.mark.parametrize("layer", ["batchnorm", "masked", "cross_modality", "simsiam"])
def test_grouped_batchnorm_waits_for_the_multi_gpu_slice(layer):
    """Per-replica statistics (groups=2; the test kept its name from when the
    port refused groups > 1): each layer in train mode against the JAX
    package's with the same weights and running stats, outputs and running
    stats 1e-6 (the SimSiam MLP's and the CM loss, three products deep,
    1e-5); its parameter and buffer names are those of groups=1."""
    jmod, port, twin, ins = _grouped_layers(layer)
    assert list(port.state_dict()) == list(twin.state_dict())
    kw = ({"train": True} if layer in ("cross_modality", "simsiam")
          else {"use_running_average": False})
    jins = [jnp.asarray(a) for a in ins]
    v = jmod.init(jax.random.key(0), *jins, **kw)
    r = np.random.RandomState(12)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * r.randn(*a.shape).astype(np.float32),
                          v.get("params", {}))
    stats = random_stats(v["batch_stats"], r)
    ref, muts = jmod.apply({"params": params, "batch_stats": stats}, *jins, **kw,
                           mutable=["batch_stats"])
    port.load_state_dict(from_jax_params(params, stats, port))
    got = port.train()(*[torch.from_numpy(np.asarray(a)) for a in ins[:-1]], float(ins[-1])) \
        if layer == "cross_modality" else port.train()(*map(torch.from_numpy, ins))
    tol = 1e-5 if layer in ("cross_modality", "simsiam") else 1e-6
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=tol)
    new = _flat(muts["batch_stats"])
    moved = to_jax_paths(port.state_dict(), port)
    assert set(new) <= set(moved)
    for k, want in new.items():
        np.testing.assert_allclose(moved[k], want, rtol=0, atol=tol, err_msg=k)


# --- loss functions -------------------------------------------------------------------

def test_ssl_loss_functions_match_jax():
    r = np.random.RandomState(2)
    x, y = r.randn(7, 9).astype(np.float32), r.randn(7, 9).astype(np.float32)
    np.testing.assert_allclose(pssl.negcos_loss(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(jssl.negcos_loss(jnp.asarray(x), jnp.asarray(y))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        float(pssl.nt_xent_loss(torch.from_numpy(x), torch.from_numpy(y))),
        float(jssl.nt_xent_loss(jnp.asarray(x), jnp.asarray(y))), rtol=0, atol=1e-6)
    logits = (3 * r.randn(3, 11, 27)).astype(np.float32)
    labels = r.randint(0, 27, size=(3, 11)).astype(np.int32)
    labels[0] = 0                                      # a row with nothing to predict
    for lab in (labels, np.zeros_like(labels)):
        np.testing.assert_allclose(
            float(pssl._masked_ce(torch.from_numpy(logits), torch.from_numpy(lab))),
            float(jssl._masked_ce(jnp.asarray(logits), jnp.asarray(lab))), rtol=0, atol=1e-6)
    assert pssl._masked_ce(torch.from_numpy(logits).bfloat16(),
                           torch.from_numpy(labels)).dtype == torch.float32


def _triplet_inputs(case):
    r = np.random.RandomState(3)
    P = 6
    p = r.randn(P, 8).astype(np.float32)
    d = r.randn(P, 8).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pv = np.array([1, 1, 1, 1, 0, 0], bool)
    dv = np.array([1, 1, 1, 1, 1, 0], bool)
    gt = np.full((P, P), -1.0, np.float32)
    gt[:4, :5] = 0.0
    gt[0, 1] = gt[0, 3] = gt[2, 0] = 1.0             # rows 1 and 3: no positives (fallback)
    if case == "no_positives":
        gt[gt == 1.0] = 0.0
    elif case == "all_invalid":
        pv[:] = dv[:] = False
        gt[:] = -1.0
    return p, d, pv, dv, gt


@pytest.mark.parametrize("case", ["mixed", "no_positives", "all_invalid"])
@pytest.mark.parametrize("margin", [0.5, 0.05])
def test_triplet_loss_matches_jax(case, margin):
    args = _triplet_inputs(case)
    ref = float(jcm.triplet_loss(*map(jnp.asarray, args), jnp.float32(margin)))
    got = float(pcm.triplet_loss(*map(torch.from_numpy, args), margin))
    assert abs(got - ref) <= 1e-6, (got, ref)
    if case == "all_invalid":
        assert got == 0.0


# --- the MLM sampler ------------------------------------------------------------------

def _token_rows(seed=4, B=6, L=90):
    """Rows in the protein layouts: maskable tokens first then pad, tiled
    with a leading pad per tile (the dataset's layout), all pad, all tokens."""
    r = np.random.RandomState(seed)
    seq = np.zeros((B, L), np.int32)
    seq[0, :37] = r.randint(1, 26, 37)
    for t in range(3):
        seq[1, t * 30 + 1 : t * 30 + 22] = r.randint(1, 26, 21)
    seq[3, :] = r.randint(1, 26, L)
    seq[4, :5] = r.randint(1, 26, 5)
    seq[5, 40:] = r.randint(1, 26, 50)
    return seq


def test_mlm_sampler_keeps_the_reference_counts():
    """The number of masked positions in a row is a function of the row's
    mask alone, K = #{j < ceil(0.15·L) : cumsum(maskable)[j] ≤
    ceil(0.15·n_maskable)}, so it equals the JAX sampler's for any draw; with
    the maskable tokens first, K = min(ceil(0.15·n), ceil(0.15·L)).  A row
    with at least K maskable tokens gets no pad position (an all-pad row gets
    pad positions in both packages, with label 0).  Labels hold the token
    at a masked position and 0 elsewhere."""
    seq = _token_rows()
    L = seq.shape[1]
    maskable = seq != 0
    n = maskable.sum(1)
    K = [int((np.cumsum(maskable[b])[: math.ceil(0.15 * L)]
              <= np.ceil(np.float32(n[b]) * np.float32(0.15))).sum()) for b in range(len(seq))]
    g = torch.Generator().manual_seed(0)
    for draw in range(3):
        ref = np.asarray(jmask.mlm_mask(jnp.asarray(seq), jax.random.key(draw))[2])
        masked, labels, mask = pmask.mlm_mask(torch.from_numpy(seq), g)
        mask, labels, masked = mask.numpy(), labels.numpy(), masked.numpy()
        np.testing.assert_array_equal(mask.sum(1), K)
        np.testing.assert_array_equal(ref.sum(1), K)
        for row in (0, 3, 4):
            assert K[row] == min(math.ceil(0.15 * n[row]), math.ceil(0.15 * L)), row
        enough = n >= np.array(K)
        assert not enough[2] and enough[[0, 1, 3, 4, 5]].all()
        assert not (mask & ~maskable)[enough].any()
        np.testing.assert_array_equal(labels, np.where(mask, seq, 0))
        assert ((masked == 26) <= mask).all()
        np.testing.assert_array_equal(masked[~mask], seq[~mask])


def test_mlm_sampler_replaces_about_ninety_percent_and_follows_its_generator():
    r = np.random.RandomState(5)
    seq = torch.from_numpy(r.randint(1, 26, (64, 400)).astype(np.int32))
    masked, _, mask = pmask.mlm_mask(seq, torch.Generator().manual_seed(1))
    share = float((masked[mask] == 26).float().mean())
    n = int(mask.sum())
    assert n == 64 * 60
    assert abs(share - 0.9) <= 4 * math.sqrt(0.09 / n), share
    again = pmask.mlm_mask(seq, torch.Generator().manual_seed(1))
    other = pmask.mlm_mask(seq, torch.Generator().manual_seed(2))
    assert torch.equal(again[0], masked) and torch.equal(again[2], mask)
    assert not torch.equal(other[2], mask)


# --- schedules and calibration ----------------------------------------------------------

@pytest.mark.parametrize("fn", ["tanh_decay", "cosine_anneal", "max_cosine_tanh_decay",
                                "no_decay"])
def test_margin_schedule_is_bit_identical(fn):
    ref, got = JMarginSchedule(0.5, 30, 7, fn), MarginSchedule(0.5, 30, 7, fn)
    seq_ref = [ref.margin] + [ref.step() for _ in range(20)]
    seq_got = [got.margin] + [got.step() for _ in range(20)]
    assert seq_got == seq_ref
    assert got.state_dict() == ref.state_dict()
    fresh = MarginSchedule(0.5, 30, 7, fn)
    fresh.load_state_dict(got.state_dict())
    assert fresh.step() == ref.step()
    assert MarginSchedule(n_epoch=100).n_re == JMarginSchedule(n_epoch=100).n_re == 20


@pytest.mark.parametrize("cycle_mult,gamma", [(1.0, 1.0), (2.0, 0.5)])
def test_cosine_warmup_restarts_lr_is_bit_identical(cycle_mult, gamma):
    for warmup in (0, 2, 4):
        for epoch in range(60):
            kw = dict(first_cycle_steps=10, max_lr=1e-4, warmup_steps=warmup,
                      cycle_mult=cycle_mult, gamma=gamma)
            assert cosine_warmup_restarts_lr(epoch, **kw) == jlr(epoch, **kw)


def _calibration_cases():
    r = np.random.RandomState(6)
    cases = []
    for k in range(-12, 13):
        for w in (1.0, 1e-3, 10.0):
            cls = float(r.uniform(0.05, 1.5))
            cases.append((cls * 10.0 ** k * float(r.uniform(1, 9.9)), cls, w))
    return cases + [(0.0, 0.7, 1.0), (0.0, 0.7, 1e-2)]


def _f32_loops(cm, cls, w, tenth=None):
    """The reference's while loops in f32 scalars; ``tenth`` given, each
    division by 10 is a product with it instead."""
    cm, cls, w, ten = np.float32(cm), np.float32(cls), np.float32(w), np.float32(10)
    if not cm > 0:
        return w
    while (cm * w / ten if tenth is None else cm * w * tenth) > cls:
        w = w / ten if tenth is None else w * tenth
    while cm * w * ten < cls:
        w = w * ten
    return w


def test_calibration_on_the_device_is_exact():
    """The unrolled ``_calibrate`` equals the reference's while loops bit for
    bit: in f64 against ``tools/two_framework_train.py::_torch_calibrate``
    (Python floats), in f32 against the same loops in f32 scalars.  The JAX
    package's ``_calibrate`` agrees with it exactly when its first loop does
    not run; when it divides, XLA (CPU) computes w/10 as w·f32(0.1), so the
    JAX result is those loops with that product, within one f32 rounding per
    division of the port's."""
    divided = 0
    for cm, cls, w in _calibration_cases():
        got64 = psteps._calibrate(*(torch.tensor(v, dtype=torch.float64) for v in (cm, cls, w)))
        assert got64.item() == _torch_calibrate(cm, cls, w), (cm, cls, w)
        got32 = psteps._calibrate(*(torch.tensor(v, dtype=torch.float32) for v in (cm, cls, w)))
        assert got32.numpy().tobytes() == _f32_loops(cm, cls, w).tobytes(), (cm, cls, w)
        ref32 = np.asarray(jsteps._calibrate(*(jnp.float32(v) for v in (cm, cls, w))))
        if got32.item() >= np.float32(w):
            assert got32.numpy().tobytes() == ref32.tobytes(), (cm, cls, w)
        else:
            divided += 1
            assert ref32.tobytes() == _f32_loops(cm, cls, w, np.float32(0.1)).tobytes()
            n = round(math.log10(w / got32.item()))
            assert abs(got32.item() / float(ref32) - 1) <= n * 2.0 ** -23, (cm, cls, w)
    assert divided


# --- the SSL and CM heads ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(name):
    """``build_pair`` once per model in this file (the flax init is jitted, some
    15 s each); callers deep-copy the port model before they change it."""
    return build_pair(name, tiny_cfg())


@pytest.fixture(scope="module")
def pair_2c2p():
    return _pair("DrugLAMP2C2P")


def _head_inputs(cfg, seed=7):
    r = np.random.RandomState(seed)
    b = jsyn.make_batch(cfg, 3, seed=seed, n_drug_feature=ND, n_prot_feature=NP)
    N, L, nh = cfg.drug.max_nodes, cfg.protein.seq_len, cfg.n_hidden
    return {"vp": b["vp"], "xp": r.randn(3, L, NP + 1).astype(np.float32),
            "fill_bit_p": b["p_fill"], "vd": r.randn(3, N, nh).astype(np.float32),
            "xd": r.randn(3, N, ND + 1).astype(np.float32)}


@pytest.mark.parametrize("mode", ["double", "vp", "xp"])
def test_ssl_head_matches_jax(pair_2c2p, fixed_mask, mode):
    """``SSL`` in train mode with the injected mask: both losses 1e-5, the
    running stats of the shared ProteinCNN and of the SimSiam heads 1e-5."""
    jmodel, params, stats, pmodel = pair_2c2p
    cfg = tiny_cfg()
    ins = _head_inputs(cfg)
    (ref, muts) = jmodel.apply(
        {"params": params, "batch_stats": stats},
        *(jnp.asarray(ins[k]) for k in ("vp", "xp", "fill_bit_p", "vd", "xd")),
        method=lambda m, *a: m.ssl_model(*a, None, p_mode=mode, train=True),
        mutable=["batch_stats"])
    model = copy.deepcopy(pmodel).train()
    assert model.ssl_model.prot_extractor is model.protein_extractor
    got = model.ssl_model(*(torch.from_numpy(ins[k]) for k in ("vp", "xp", "fill_bit_p", "vd",
                                                               "xd")), None, p_mode=mode)
    for k in ("prot_ssl", "drug_ssl"):
        assert abs(float(got[k]) - float(ref[k])) <= 1e-5, (k, float(got[k]), float(ref[k]))
    new = _flat(muts["batch_stats"])
    port = to_jax_paths(model.state_dict(), model)
    moved = [k for k in new if not np.array_equal(new[k], _flat(stats)[k])]
    assert any(k.startswith("protein_extractor/") for k in moved) == (mode != "xp")
    assert any(k.startswith("ssl_model/") for k in moved)
    for k in new:
        np.testing.assert_allclose(port[k], new[k], rtol=0, atol=1e-5, err_msg=k)


def test_cross_modality_head_matches_jax(pair_2c2p):
    jmodel, params, stats, pmodel = pair_2c2p
    r = np.random.RandomState(8)
    nh = tiny_cfg().n_hidden
    xs = [r.randn(B, 5, nh).astype(np.float32) for _ in range(4)]
    cm = build_cm_arrays(PIDS, DIDS, LABELS)
    args = [cm[k] for k in ("p_index", "p_valid", "d_index", "d_valid", "gt")]
    ref, muts = jmodel.apply({"params": params, "batch_stats": stats},
                             *map(jnp.asarray, xs + args), jnp.float32(MARGIN),
                             method=lambda m, *a: m.cm_model(*a, train=True),
                             mutable=["batch_stats"])
    model = copy.deepcopy(pmodel).train()
    got = model.cm_model(*map(torch.from_numpy, xs + args), MARGIN)
    assert abs(float(got) - float(ref)) <= 1e-5, (float(got), float(ref))
    port = to_jax_paths(model.state_dict(), model)
    for k, v in _flat(muts["batch_stats"]).items():
        np.testing.assert_allclose(port[k], v, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["DrugLAMP", "DrugLAMPwoLLM", "DrugLAMP2C2P"])
def test_bridge_round_trips_every_leaf(name):
    """Every JAX leaf of the whole tree (the SSL and CM heads included) maps to
    one port key, none is left over, and ``to_jax_paths`` gives the trees back
    exactly."""
    cfg = tiny_cfg()
    # DrugLAMP's tree is DrugLAMP2C2P's (both build every head)
    _, params, stats, _ = _pair("DrugLAMPwoLLM" if name == "DrugLAMPwoLLM" else "DrugLAMP2C2P")
    model = port_build_model(name, port_config(cfg), ND, NP)
    state = from_jax_params(params, stats, model)
    leaves = {**_flat(params), **_flat(stats)}
    assert len(state) == len(leaves) == len(model.state_dict())
    assert any(k.startswith("ssl_model.") for k in state)
    assert any(k.startswith("cm_model.") for k in state)
    model.load_state_dict(state)
    back = to_jax_paths(model.state_dict(), model)
    assert set(back) == set(leaves)
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# --- the step ---------------------------------------------------------------------------

GATES = {"ssl": (True, False, False), "cm": (False, True, False), "ssl_cm": (True, True, False),
         "ssl_cm_calibrate": (True, True, True)}
COMBOS = {"DrugLAMP2C2P": list(GATES), "DrugLAMPwoLLM": ["ssl"]}


def _step_batch(cfg):
    b = jsyn.make_batch(cfg, B, seed=9, n_drug_feature=ND, n_prot_feature=NP)
    c = jenc.compact_batch(b, (b["d_fill"] == 0).sum(1))
    c["labels"] = LABELS.copy()
    c["cm"] = build_cm_arrays(PIDS, DIDS, LABELS)
    return c


def _jax_loss_grads(jmodel, use_cm):
    """The JAX step's shared forward as a function of (params, batch_stats,
    decoded batch): the (cls, ssl, raw cm) losses at those weights, one
    gradient per loss, and the running stats after cls, ssl and cm (threaded
    in that order)."""

    def fn(p, s, decoded):
        def losses_fn(p):
            out, m1 = jmodel.apply({"params": p, "batch_stats": s}, decoded, train=True,
                                   rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
            _, cls = jbce(out["score"], decoded["labels"])
            ssl_d, m2 = jmodel.apply({"params": p, "batch_stats": m1["batch_stats"]},
                                     out["ssl_inputs"], jax.random.key(1), True,
                                     method="ssl_loss", mutable=["batch_stats"])
            ssl = (ssl_d["prot_ssl"] + ssl_d["drug_ssl"]) * 0.1
            cm, s3 = jnp.float32(0.0), m2["batch_stats"]
            if use_cm:
                cm, m3 = jmodel.apply({"params": p, "batch_stats": m2["batch_stats"]},
                                      out["cm_inputs"], decoded["cm"], jnp.float32(MARGIN), True,
                                      method="cm_loss", mutable=["batch_stats"])
                s3 = m3["batch_stats"]
            return (cls, ssl, cm), (m1["batch_stats"], m2["batch_stats"], s3)

        losses, vjp, stages = jax.vjp(losses_fn, p, has_aux=True)
        units = jnp.eye(3, dtype=jnp.float32)
        grads = [vjp(tuple(units[i]))[0] for i in range(3 if use_cm else 2)]
        return losses, grads, stages

    return fn


def _jax_reference(name, jmodel, params, stats, batch):
    """One JAX program: the values, gradients and running stats of the JAX
    step's shared forward (``_jax_loss_grads``) at the initial weights, and
    the JAX step itself on the full gate (2C2P) or the ssl gate (woLLM),
    per_loss."""
    use_cm = name == "DrugLAMP2C2P"
    jbatch = jax.tree.map(jnp.asarray, batch)
    body = jsteps._make_step_body(jmodel, True, use_cm, use_cm, "per_loss", 1)
    loss_grads = _jax_loss_grads(jmodel, use_cm)

    @jax.jit
    def run(p, s, state):
        losses, grads, stages = loss_grads(p, s, jenc.decode_batch(dict(jbatch)))
        out = body(state, jbatch, jax.random.key(2), *map(jnp.float32, (LR, LR_SSL, LR_CM,
                                                                        MARGIN, CM_W0)))
        return losses, grads, stages, out

    state = JTrainState.create({"params": jax.tree.map(jnp.array, params),
                                "batch_stats": jax.tree.map(jnp.array, stats)}, True, use_cm)
    return run(params, stats, state)


def _compose(params, stats, losses, grads, stages, gates, grad_mode):
    """The JAX step for one gate combination, composed from the JAX package's
    ``_calibrate`` and ``apply_optimizer`` as ``_make_step_body`` composes
    them; → (flat params, flat stats, cm weight, [(lr, flat gradient) of each
    optimizer in the order applied])."""
    use_ssl, use_cm, calibrate = gates
    cls, _, cm_raw = losses
    w = jsteps._calibrate(cm_raw, cls, jnp.float32(CM_W0)) if calibrate else jnp.float32(CM_W0)
    g = {"cls": grads[0], "ssl": grads[1] if use_ssl else None,
         "cm": jax.tree.map(lambda x: x * w, grads[2]) if use_cm else None}
    if grad_mode == "legacy_aliased":
        last = g["cm" if use_cm else "ssl" if use_ssl else "cls"]
        g = {k: (last if v is not None else None) for k, v in g.items()}
    state = JTrainState.create({"params": params, "batch_stats": stats}, use_ssl, use_cm)
    p, _ = japply(state.opt_cls, g["cls"], state.params, jnp.float32(LR))
    applied = [(LR, _flat(g["cls"]))]
    if use_ssl:
        p, _ = japply(state.opt_ssl, g["ssl"], p, jnp.float32(LR_SSL))
        applied.append((LR_SSL, _flat(g["ssl"])))
    if use_cm:
        p, _ = japply(state.opt_cm, g["cm"], p, jnp.float32(LR_CM))
        applied.append((LR_CM, _flat(g["cm"])))
    s1, s2, s3 = stages
    final = s3 if (use_ssl and use_cm) else s2 if use_ssl else (
        {**s1, "cm_model": s3["cm_model"]} if use_cm else s1)
    return _flat(p), _flat(final), np.float32(w), applied


def _adam_direction(g):
    return g / (np.abs(g) + 1e-8)


def _accumulating(params, losses, grads):
    """The known wrong port of the reference's three optimizers (torch 2.x
    ``zero_grad`` leaves the gradients to accumulate:
    ``tests/torch_mirror.py::wrong_accumulating_train_step``): each of the
    AdamWs in use applies g_cls + g_ssl (+ w·g_cm); the flat parameters of
    the widest gate (ssl + cm + calibrate, or ssl without the CM loss)."""
    cls, _, cm_raw = losses
    use_cm = len(grads) == 3
    w = jsteps._calibrate(cm_raw, cls, jnp.float32(CM_W0))
    g = jax.tree.map(lambda a, b, *c: a + b + (c[0] * w if c else 0.0), *grads)
    state = JTrainState.create({"params": params, "batch_stats": {}}, True, use_cm)
    p, _ = japply(state.opt_cls, g, state.params, jnp.float32(LR))
    p, _ = japply(state.opt_ssl, g, p, jnp.float32(LR_SSL))
    if use_cm:
        p, _ = japply(state.opt_cm, g, p, jnp.float32(LR_CM))
    return _flat(p)


def _assert_params_close(got, want, applied, rtol, atol, what, other=None):
    """``got`` against ``want`` leaf by leaf: rtol / atol where each applied
    gradient is settled, else within twice the sum of the LRs.  Settled: 0 or at
    least ADAM_NOISE (two programs whose gradients differ only by
    rounding); with ``other``, the gradients that produced ``got`` in the
    same order, where both give the same AdamW first-step direction to
    1e-4."""
    noisy = total = 0
    for k, v in want.items():
        settled = np.ones(v.shape, bool)
        for i, (_, gr) in enumerate(applied):
            if other is None:
                settled &= (gr[k] == 0) | (np.abs(gr[k]) >= ADAM_NOISE)
            else:
                settled &= np.abs(_adam_direction(gr[k]) - _adam_direction(other[i][1][k])) <= 1e-4
        bound = 2 * sum(lr for lr, _ in applied)     # a first update lies in [-lr, lr]
        np.testing.assert_allclose(got[k][settled], v[settled], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")
        assert np.all(np.abs(got[k] - v)[~settled] <= bound), (what, k)
        noisy += int((~settled).sum())
        total += v.size
    assert noisy <= MAX_NOISY * total, (what, noisy, total)


@pytest.fixture(scope="module", params=list(COMBOS))
def step_runs(request):
    """JAX's reference and the port's step for every gate combination and
    grad mode of one model, from the same weights and the same batch."""
    name = request.param
    cfg = tiny_cfg()
    jmodel, params, stats, pmodel = _pair(name)
    batch = _step_batch(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssl, "mlm_mask", _jax_fixed_mask)
        mp.setattr(pmask, "mlm_mask", _port_fixed_mask)
        losses, grads, stages, jout = _jax_reference(name, jmodel, params, stats, batch)
        ref = {"losses": [float(x) for x in losses],
               "grads": [_flat(gr) for gr in grads], "runs": {},
               "step": ({**_flat(jout.state.params)}, _flat(jout.state.batch_stats),
                        np.float32(jout.cm_weight),
                        [float(x) for x in (jout.cls_loss, jout.ssl_loss, jout.cm_loss)])}
        port = {"runs": {}}
        tbatch = to_torch({k: v for k, v in batch.items() if k != "cm"})
        tbatch["cm"] = to_torch(batch["cm"])
        for gate in COMBOS[name]:
            use_cm = GATES[gate][1]
            for mode in ("per_loss", "legacy_aliased"):
                ref["runs"][gate, mode] = _compose(params, stats, losses, grads, stages,
                                                   GATES[gate], mode)
                model = copy.deepcopy(pmodel)
                state = TrainState.create(model, GATES[gate][0], use_cm)
                step = psteps.make_train_step(model, *GATES[gate], grad_mode=mode, device="cpu")
                out = step(state, tbatch, None, LR, LR_SSL, LR_CM, MARGIN, CM_W0)
                port["runs"][gate, mode] = (
                    to_jax_paths(model.state_dict(), model),
                    np.float32(out.cm_weight),
                    [float(x) for x in (out.cls_loss, out.ssl_loss, out.cm_loss)], state.step)
        model = copy.deepcopy(pmodel).train()
        decoded = penc.decode_batch(dict(tbatch))
        *plosses, _, _, pgrads = psteps.loss_gradients(
            model, decoded, None, True, name == "DrugLAMP2C2P", False, MARGIN,
            torch.ones(()))
        port["losses"] = [float(x) for x in plosses]
        names = [n for n, _ in model.named_parameters()]
        port["grads"] = {k: to_jax_paths(dict(zip(names, v)), model) for k, v in pgrads.items()}
        trees = [traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                               for k, v in port["grads"][loss].items()})
                 for loss in ("cls", "ssl", "cm")[:len(grads)]]
        ref["on_port_grads"] = {key: _compose(params, stats, losses, trees, stages, GATES[key[0]],
                                              key[1])
                                for key in ref["runs"]}
        ref["accumulating"] = _accumulating(params, losses, grads)
    return name, ref, port


def test_step_losses_match_jax(step_runs):
    name, ref, port = step_runs
    cls, ssl, cm = ref["losses"]
    assert abs(port["losses"][0] - cls) <= 1e-5 and abs(port["losses"][1] - ssl) <= 1e-5
    assert abs(port["losses"][2] - (cm if name == "DrugLAMP2C2P" else 0.0)) <= 1e-5
    for (gate, mode), (_, w, losses, steps) in port["runs"].items():
        use_ssl, use_cm, _ = GATES[gate]
        want_w = ref["runs"][gate, mode][2]
        assert w == want_w, (gate, mode, w, want_w)
        assert steps == 1
        assert abs(losses[0] - cls) <= 1e-5
        assert abs(losses[1] - (ssl if use_ssl else 0.0)) <= 1e-5
        assert abs(losses[2] - (cm * float(want_w) if use_cm else 0.0)) <= 1e-5


def test_step_gradients_leaf_by_leaf(step_runs):
    """Each loss's gradient at the weights before the step; every leaf of the
    tree, zeros where a loss does not reach."""
    name, ref, port = step_runs
    for i, loss in enumerate(("cls", "ssl", "cm")[:len(ref["grads"])]):
        got, want = port["grads"][loss], ref["grads"][i]
        assert set(got) == set(want)
        reached = [k for k, v in want.items() if np.abs(v).max() > 0]
        assert reached, loss
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=5e-3, atol=5e-5, err_msg=f"{loss} {k}")


def test_composed_reference_is_the_jax_step(step_runs):
    """The composition the other checks use equals the JAX step itself on the
    gate that the JAX program ran (the two programs fuse their sums
    differently, so the running stats agree to 1e-6 and the parameters as
    ``_assert_params_close`` holds them, at rtol 1e-6 / atol 1e-8)."""
    name, ref, _ = step_runs
    gate = "ssl_cm_calibrate" if name == "DrugLAMP2C2P" else "ssl"
    params, stats, w, applied = ref["runs"][gate, "per_loss"]
    sparams, sstats, sw, slosses = ref["step"]
    assert w == sw
    assert slosses[0] == ref["losses"][0] and abs(slosses[1] - ref["losses"][1]) <= 1e-6
    _assert_params_close(params, sparams, applied, 1e-6, 1e-8, gate)
    for k in sstats:
        np.testing.assert_allclose(stats[k], sstats[k], rtol=0, atol=1e-6, err_msg=k)


def test_step_parameters_and_stats_match_jax(step_runs):
    """After the three AdamWs, in every gate combination and both grad modes:
    the parameters rtol 1e-5 / atol 1e-7 against the JAX package's
    calibration and optimizers applied to the port's gradients, and within
    the LRs' reach (2·Σlr) against the whole JAX composition where its gradients are
    rounding noise (``_assert_params_close``); running stats 1e-5."""
    name, ref, port = step_runs
    for key, (got, w, _, _) in port["runs"].items():
        params, stats, _, applied = ref["runs"][key]
        on_port, _, w_port, port_applied = ref["on_port_grads"][key]
        assert set(got) == set(params) | set(stats), key
        assert w == w_port, key
        for k, v in on_port.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=f"{key} {k}")
        _assert_params_close(got, params, applied, 1e-5, 1e-7, key, port_applied)
        for k, v in stats.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=f"{key} {k}")


def test_cm_gate_needs_the_2c2p_inputs():
    """DrugLAMP and DrugLAMPwoLLM return no CM inputs (the JAX package's
    forwards neither): their CM gate is refused."""
    cfg = port_config(tiny_cfg())
    for name in ("DrugLAMP", "DrugLAMPwoLLM"):
        model = port_build_model(name, cfg, ND, NP)
        with pytest.raises(ValueError, match="CM"):
            psteps.make_train_step(model, False, True, device="cpu")


@pytest.mark.parametrize("grad_mode", ["per_loss", "legacy_aliased"])
def test_step_rejects_the_accumulating_port(step_runs, grad_mode):
    """Negative control: the parameter check above fails against the
    accumulating optimizers (every AdamW applying the summed gradients), so
    it can tell the port's full-gate step from that known wrong answer."""
    name, ref, port = step_runs
    gate = "ssl_cm_calibrate" if name == "DrugLAMP2C2P" else "ssl"
    got = port["runs"][gate, grad_mode][0]
    wrong = ref["accumulating"]
    off = sum(int((np.abs(got[k] - v) > 1e-7 + 1e-5 * np.abs(v)).sum()) for k, v in wrong.items())
    total = sum(v.size for v in wrong.values())
    assert off > 0.1 * total, (off, total)
