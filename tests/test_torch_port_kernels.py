"""The port's attention module (druglamp_tpu_torch/kernels/attention.py) against
the JAX package's Pallas kernels, forward and backward, run in interpret mode
on the CPU as tests/test_kernels.py runs them; the autograd wiring of the
CUDA path with the launches emulated on the CPU; the dispatch rules, the
operand checks and the build's library naming.  The CUDA kernels themselves are tested on a
card by tests/test_torch_port_cuda.py."""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import druglamp_tpu.kernels.paired_attention_pallas as pk
from druglamp_tpu.kernels.paired_attention import _attn
from druglamp_tpu_torch.kernels import attention, build
from druglamp_tpu_torch.nn.pmma import PMMABlock


@pytest.fixture(autouse=True)
def interpret_mode():
    pk.INTERPRET = True
    yield
    pk.INTERPRET = False


def _operands(shapes, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32) for s in shapes]


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("L,S,D", [(32, 32, 16), (32, 64, 16), (24, 40, 64)])
def test_paired_plain_matches_pallas(L, S, D):
    B, H = 2, 2
    q, k, v, qo = _operands([(B, H, L, D), (B, H, S, D), (B, H, S, D), (B, H, L, D)])
    s_ref, g_ref = pk.paired_attention_pallas(*map(jnp.asarray, (q, k, v, qo)))
    s, g = attention.paired_attention(*map(_t, (q, k, v, qo)))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L,S,D", [(32, 32, 16), (20, 36, 128)])
def test_self_plain_matches_pallas(L, S, D):
    B, H = 2, 2
    q, k, v = _operands([(B, H, L, D), (B, H, S, D), (B, H, S, D)], seed=1)
    ref = pk.self_attention_pallas(*map(jnp.asarray, (q, k, v)))
    out = attention.self_attention(*map(_t, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_bf16_inputs():
    """bf16 operands: the port's plain version rounds the probabilities to
    bf16 as the reference's unfused ``_attn`` does (equal up to f32 summation
    order), while the Pallas kernel keeps them in f32 (within one bf16 ulp of
    the output's largest magnitude)."""
    B, H, L, S, D = 2, 2, 32, 48, 64
    q, k, v, qo = _operands([(B, H, L, D), (B, H, S, D), (B, H, S, D), (B, H, L, D)], seed=2)
    jq, jk, jv, jqo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, qo))
    tq, tk, tv, tqo = (_t(a, torch.bfloat16) for a in (q, k, v, qo))
    s, g = attention.paired_attention(tq, tk, tv, tqo)
    assert s.dtype == g.dtype == torch.bfloat16
    for out, qq in ((s, jq), (g, jqo)):
        ref = np.asarray(_attn(qq, jk, jv)[0].astype(jnp.float32))
        np.testing.assert_allclose(out.float().numpy(), ref, atol=_bf16_ulp(np.abs(ref).max()))
    s_p, g_p = pk.paired_attention_pallas(jq, jk, jv, jqo)
    for out, ref in ((s, s_p), (g, g_p)):
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.abs(out.float().numpy() - ref).max() <= _bf16_ulp(np.abs(ref).max())


# Keys per chunk of the bf16 forward kernels (csrc/attention.cu): the paired
# kernel's and the self kernel's.
PAIRED_CHUNK, SELF_CHUNK = 64, 128


def _tile_attention(q, k, v, chunk=PAIRED_CHUNK):
    """What csrc/attention.cu's bf16 tensor-core kernels compute, in f32
    torch: an online softmax over ``chunk``-key chunks (keys ≥ S of the last
    chunk are zero rows masked to -inf), P split into bf16 terms P_hi + P_lo,
    both products accumulated in f32, O/l rounded to bf16 → (out, lse)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    S, D = k.shape[-2], k.shape[-1]
    pad = -S % chunk
    kf, vf = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (kf, vf))
    m = torch.full(q.shape[:-1], -math.inf)
    l, acc = torch.zeros(q.shape[:-1]), torch.zeros(q.shape)
    for c0 in range(0, S, chunk):
        s = torch.matmul(qf, kf[..., c0:c0 + chunk, :].transpose(-1, -2)) / math.sqrt(D)
        s[..., max(0, S - c0):] = -math.inf
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float()
        vc = vf[..., c0:c0 + chunk, :]
        acc = acc * alpha[..., None] + torch.matmul(p_hi, vc) + torch.matmul(p_lo, vc)
        m = m_new
    return (acc / l[..., None]).bfloat16(), m + torch.log(l)


@pytest.mark.parametrize("L,S,D,paired", [
    (256, 256, 64, True), (256, 256, 128, False), (37, 70, 128, True), (100, 33, 64, False),
    (200, 300, 128, False),
])
def test_tile_algorithm_keeps_the_bf16_tolerance(L, S, D, paired):
    """The bf16 kernel's tile algorithm on bf16 inputs: within one bf16 ulp at
    the output's largest magnitude of the Pallas kernel (interpret mode) and
    of the port's plain version; its lse within 1e-5 of the log-sum-exp of the
    scaled f32 logits."""
    B, H = 1, 2
    q, k, v, qo = _operands([(B, H, L, D), (B, H, S, D), (B, H, S, D), (B, H, L, D)], seed=6)
    jq, jk, jv, jqo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, qo))
    tq, tk, tv, tqo = (_t(a, torch.bfloat16) for a in (q, k, v, qo))
    if paired:
        pallas = pk.paired_attention_pallas(jq, jk, jv, jqo)
        queries = (tq, tqo)
    else:
        pallas = (pk.self_attention_pallas(jq, jk, jv),)
        queries = (tq,)
    for qq, ref in zip(queries, pallas):
        out, lse = _tile_attention(qq, tk, tv, PAIRED_CHUNK if paired else SELF_CHUNK)
        ref = np.asarray(ref.astype(jnp.float32))
        got = out.float().numpy()
        assert np.abs(got - ref).max() <= _bf16_ulp(np.abs(ref).max())
        plain = attention.attention_plain(qq, tk, tv)[0].float().numpy()
        assert np.abs(got - plain).max() <= _bf16_ulp(np.abs(plain).max())
        logits = torch.matmul(qq.float(), tk.float().transpose(-1, -2)) / math.sqrt(D)
        torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-5, rtol=0)


def _split(x, split=True):
    """x as the kernels feed it to a product from registers: bf16 hi + lo
    (or one bf16 rounding), in f32."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def _tile_attention_bwd(qs, k, v, dos, split=(True, True, True)):
    """What csrc/attention_bwd.cu's bf16 tensor-core kernels compute, in f32
    torch, for the query sets ``qs`` with incoming gradients ``dos``: O and lse
    from the forward's tile algorithm; δ = rowsum(dO ⊙ O) of the bf16 O; the dQ
    kernel over 64-key chunks (P recomputed from lse, keys ≥ S zero), the
    dK/dV kernel over 64-row query chunks of every set into one f32
    accumulator; P (dV += Pᵀ dO), dS (dQ += dS K) and dSᵀ (dK += dSᵀ Q) fed as
    bf16 hi + lo where ``split`` says so, else rounded once; f32 accumulation
    and one rounding → ([dq per set], dk, dv) in bf16."""
    L, S, D = qs[0].shape[-2], k.shape[-2], k.shape[-1]
    scale = 1 / math.sqrt(D)
    split_p, split_dq, split_dk = split
    kf, vf = k.float(), v.float()
    dqs, dk, dv = [], torch.zeros(k.shape), torch.zeros(v.shape)
    for q, do in zip(qs, dos):
        o, lse = _tile_attention(q, k, v, PAIRED_CHUNK if len(qs) == 2 else SELF_CHUNK)
        qf, dof = q.float(), do.float()
        delta = (dof * o.float()).sum(-1, keepdim=True)
        dq = torch.zeros(q.shape)
        for c0 in range(0, S, 64):                      # the dQ kernel's key chunks
            kc, vc = kf[..., c0:c0 + 64, :], vf[..., c0:c0 + 64, :]
            p = torch.exp(torch.matmul(qf, kc.transpose(-1, -2)) * scale - lse[..., None])
            ds = p * (torch.matmul(dof, vc.transpose(-1, -2)) - delta)
            dq = dq + torch.matmul(_split(ds, split_dq), kc)
        dqs.append((dq * scale).bfloat16())
        for r0 in range(0, L, 64):                      # the dK/dV kernel's query chunks
            qc, doc = qf[..., r0:r0 + 64, :], dof[..., r0:r0 + 64, :]
            pt = torch.exp(torch.matmul(kf, qc.transpose(-1, -2)) * scale
                           - lse[..., None, r0:r0 + 64])
            dst = pt * (torch.matmul(vf, doc.transpose(-1, -2)) - delta[..., r0:r0 + 64, 0][..., None, :])
            dv = dv + torch.matmul(_split(pt, split_p), doc)
            dk = dk + torch.matmul(_split(dst, split_dk), qc)
    return dqs, (dk * scale).bfloat16(), dv.bfloat16()


def _bf16_backward_case(L, S, D, paired, B=1, H=2, seed=6):
    """bf16 operands and incoming gradients from numpy → (queries, k, v, dos)."""
    q, k, v, qo, do1, do2 = (_t(a, torch.bfloat16) for a in _operands(
        [(B, H, L, D), (B, H, S, D), (B, H, S, D), (B, H, L, D), (B, H, L, D), (B, H, L, D)],
        seed=seed))
    return ((q, qo) if paired else (q,)), k, v, ((do1, do2) if paired else (do1,))


def _within_one_ulp(got, refs):
    return all((a.float() - b.float()).abs().max().item() <= _bf16_ulp(b.float().abs().max().item())
               for a, b in zip(got, refs))


@pytest.mark.parametrize("L,S,D,paired", [
    (256, 256, 64, True), (256, 256, 128, False), (37, 70, 128, True), (100, 33, 64, False),
])
def test_tile_backward_keeps_the_bf16_tolerance(L, S, D, paired):
    """The bf16 backward kernels' tile algorithm on bf16 inputs: each gradient
    within one bf16 ulp at its largest magnitude of the Pallas backward
    (interpret mode) and of the port's plain backward run in f32 on the same
    bf16 inputs (the card's tolerance)."""
    qs, k, v, dos = _bf16_backward_case(L, S, D, paired)
    dqs, dk, dv = _tile_attention_bwd(qs, k, v, dos)
    got = [dqs[0], dk, dv] + dqs[1:]
    fn = pk.paired_attention_pallas if paired else pk.self_attention_pallas
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(fn, *map(as_jax, (qs[0], k, v) + tuple(qs[1:])))
    pallas = vjp(tuple(map(as_jax, dos)) if paired else as_jax(dos[0]))
    assert _within_one_ulp(got, [torch.from_numpy(np.array(x.astype(jnp.float32)))
                                 for x in pallas])
    plain = (attention.paired_attention_bwd_plain if paired
             else attention.self_attention_bwd_plain)
    assert _within_one_ulp(got, plain(*(t.float() for t in (qs[0], k, v) + qs[1:] + dos)))


@pytest.mark.parametrize("operand,D,paired,seed", [
    ("P for dV", 128, False, 1), ("dS for dQ", 64, True, 5),
])
def test_single_rounding_breaks_the_bf16_tolerance(operand, D, paired, seed):
    """Why the kernels feed P (dV += Pᵀ dO) and dS (dQ += dS K, dK += dSᵀ Q)
    as bf16 hi + lo: at a training shape (B=16, H=4, L=S=256) on these
    inputs, one bf16 rounding of the named operand puts a gradient more than
    one bf16 ulp at its largest magnitude from the f32 plain backward, while
    the split holds every gradient within it."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, qo, do1, do2 = (torch.randn(16, 4, 256, D, generator=g).bfloat16()
                             for _ in range(6))
    qs, dos = ((q, qo), (do1, do2)) if paired else ((q,), (do1,))
    if paired:
        plain = attention.paired_attention_bwd_plain(*(t.float() for t in (q, k, v, qo, do1, do2)))
    else:
        plain = attention.attention_bwd_plain(*(t.float() for t in (q, k, v, do1)))

    def grads(split):
        dqs, dk, dv = _tile_attention_bwd(qs, k, v, dos, split)
        return [dqs[0], dk, dv] + dqs[1:]

    assert _within_one_ulp(grads((True, True, True)), plain)
    single = (False, True, True) if operand == "P for dV" else (True, False, True)
    assert not _within_one_ulp(grads(single), plain)


def test_need_weights_returns_probabilities_without_launching():
    B, H, L, S, D = 1, 2, 8, 12, 64
    q, k, v, qo = map(_t, _operands([(B, H, L, D), (B, H, S, D), (B, H, S, D), (B, H, L, D)]))
    attention.reset_launch_counts()
    s, g, p1, p2 = attention.paired_attention_core(q, k, v, qo, need_weights=True)
    assert p1.shape == p2.shape == (B, H, L, S) and p1.dtype == torch.float32
    torch.testing.assert_close(p1.sum(-1), torch.ones(B, H, L))
    torch.testing.assert_close(s, torch.matmul(p1, v))
    s2, g2, n1, n2 = attention.paired_attention_core(q, k, v, qo)
    assert n1 is None and n2 is None
    torch.testing.assert_close(s2, s)
    torch.testing.assert_close(g2, g)
    out, w = attention.self_attention_core(q, k, v, need_weights=True)
    assert w.shape == (B, H, L, S)
    assert attention.self_attention_core(q, k, v)[1] is None
    assert attention.LAUNCHES == {"paired_attention_fwd": 0, "self_attention_fwd": 0,
                                  "paired_attention_bwd": 0, "self_attention_bwd": 0}


def _ok_operands(D=64, dtype=torch.float32):
    return [torch.zeros(2, 2, 8, D, dtype=dtype), torch.zeros(2, 2, 10, D, dtype=dtype),
            torch.zeros(2, 2, 10, D, dtype=dtype), torch.zeros(2, 2, 8, D, dtype=dtype)]


@pytest.mark.parametrize("case,match", [
    ("head_dim", "head dim 32"),
    ("dtype", "dtype"),
    ("contiguous", "contiguous"),
    ("shape", "shape mismatch"),
    ("aligned", "16-byte aligned"),
    ("device", "CUDA device"),
])
def test_operand_checks_refuse(case, match):
    ops = _ok_operands()
    if case == "head_dim":
        ops = _ok_operands(D=32)
    elif case == "dtype":
        ops = _ok_operands(dtype=torch.float16)
    elif case == "contiguous":
        ops[1] = torch.zeros(2, 2, 64, 10).transpose(-1, -2)
    elif case == "shape":
        ops[3] = torch.zeros(2, 2, 9, 64)
    elif case == "aligned":  # one f32 element off a fresh buffer: 4 bytes past alignment
        ops[1] = torch.zeros(2 * 2 * 10 * 64 + 1)[1:].view(2, 2, 10, 64)
        assert ops[1].is_contiguous() and ops[1].data_ptr() % 16 == 4
    with pytest.raises(ValueError, match=match):
        attention.check_operands(*ops)


@pytest.mark.parametrize("case", ["dtype", "contiguous", "shape"])
def test_lse_checks_refuse(case):
    """The (NQ, B·H, L) f32 log-sum-exp buffer that a launch writes and the
    backward reads: anything else raises."""
    q = torch.zeros(2, 2, 8, 64)
    lse = {"dtype": torch.zeros(2, 4, 8, dtype=torch.float64),
           "contiguous": torch.zeros(2, 8, 4).transpose(1, 2),
           "shape": torch.zeros(1, 4, 8)}[case]
    attention.check_lse("paired_attention_fwd", torch.zeros(2, 4, 8), q, 2)
    with pytest.raises(ValueError, match="lse must be a contiguous"):
        attention.check_lse("paired_attention_fwd", lse, q, 2)


@pytest.mark.parametrize("case", ["count", "aligned", "contiguous", "shape"])
def test_backward_launch_refuses_outputs_and_gradients(case):
    """The forward's outputs and the incoming gradients that the backward
    kernels read (the bf16 ones through TMA maps): one per output,
    contiguous, 16-byte aligned, of the queries' shape; anything else raises
    before a launch."""
    q = torch.zeros(2, 2, 8, 64)
    lse = torch.zeros(1, 4, 8)
    outs, grads = [torch.zeros_like(q)], [torch.zeros_like(q)]
    if case == "count":
        outs = outs * 2
    elif case == "aligned":  # one f32 element off a fresh buffer: 4 bytes past alignment
        grads = [torch.zeros(q.numel() + 1)[1:].view(q.shape)]
    elif case == "contiguous":
        grads = [torch.zeros(2, 8, 2, 64).transpose(1, 2)]
    else:
        outs = [torch.zeros(2, 2, 9, 64)]
    with pytest.raises(ValueError, match="outputs and incoming gradients"):
        attention.launch_backward(q, q, q, None, outs, lse, grads)


def test_build_keys_libraries_by_source_hash():
    assert "attention" in build.sources()
    path = build.library_path("attention")
    assert path.parent == build.BUILD_DIR
    stem = path.name[len("libattention-"):-len(".so")]
    assert path.name.startswith("libattention-") and len(stem) == 16
    int(stem, 16)


def test_build_without_nvcc_raises():
    have_nvcc = shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc") \
        or os.environ.get("CUDA_HOME")
    if have_nvcc:
        pytest.skip("nvcc present: the missing-compiler path is not reachable here")
    if build.library_path("attention").exists():
        pytest.skip("library already built")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


# --- backward ----------------------------------------------------------------------

@pytest.mark.parametrize("paired,L,S,D", [
    (True, 32, 32, 16), (True, 24, 40, 64), (False, 32, 32, 16), (False, 20, 36, 128),
])
def test_backward_plain_matches_pallas_backward(paired, L, S, D):
    """The plain backward against the Pallas backward kernel (its custom vjp)
    on the same incoming gradients: 2e-5, the gradient tolerance of
    tests/test_kernels.py."""
    B, H = 2, 2
    shapes = [(B, H, L, D), (B, H, S, D), (B, H, S, D)] + [(B, H, L, D)] * (3 if paired else 1)
    ops = _operands(shapes, seed=3)
    ins, dos = ops[:4] if paired else ops[:3], ops[4:] if paired else ops[3:]
    fn = pk.paired_attention_pallas if paired else pk.self_attention_pallas
    _, vjp = jax.vjp(fn, *map(jnp.asarray, ins))
    ref = vjp(tuple(map(jnp.asarray, dos)) if paired else jnp.asarray(dos[0]))
    plain = attention.paired_attention_bwd_plain if paired else attention.self_attention_bwd_plain
    got = plain(*map(_t, ins), *map(_t, dos))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)


def _emulated_forward(q, k, v, q_other=None, with_lse=False):
    """launch_forward's contract on the CPU: outputs and the (NQ, B·H, L) lse."""
    qs = [q] if q_other is None else [q, q_other]
    outs = tuple(attention.attention_plain(x, k, v)[0] for x in qs)
    scale = 1.0 / math.sqrt(q.shape[-1])
    lse = torch.stack([torch.logsumexp(torch.matmul(x, k.transpose(-1, -2)) * scale, -1)
                       .reshape(-1, q.shape[2]) for x in qs])
    return outs, (lse if with_lse else None)


def _emulated_backward(q, k, v, q_other, outs, lse, grads):
    assert lse.shape == (len(grads), q.shape[0] * q.shape[1], q.shape[2])
    assert all(g.is_contiguous() for g in grads)
    qs = [q] if q_other is None else [q, q_other]
    for o, x in zip(outs, qs):  # the forward's outputs, which the bf16 kernels read for δ
        torch.testing.assert_close(o, attention.attention_plain(x, k, v)[0], rtol=0, atol=0)
    if q_other is None:
        return attention.self_attention_bwd_plain(q, k, v, *grads)
    return attention.paired_attention_bwd_plain(q, k, v, q_other, *grads)


@pytest.fixture
def emulated_kernels(monkeypatch):
    """Route the PMMA cores through the autograd Functions of the CUDA path,
    with the kernel launches emulated on the CPU."""
    monkeypatch.setattr(attention, "launch_forward", _emulated_forward)
    monkeypatch.setattr(attention, "launch_backward", _emulated_backward)
    monkeypatch.setattr(attention, "paired_attention",
                        lambda q, k, v, qo: attention._PairedAttention.apply(q, k, v, qo))
    monkeypatch.setattr(attention, "self_attention",
                        lambda q, k, v: attention._SelfAttention.apply(q, k, v))


@pytest.mark.parametrize("mm", [True, False])
def test_autograd_function_gives_every_projection_its_gradient(emulated_kernels, mm):
    """A PMMA block's backward through the autograd Functions: every
    query/key/value weight gets the gradient that autograd gives through the
    plain version (the incoming gradients arrive non-contiguous through
    _merge_heads; q_m feeds both paired calls and its gradients add up)."""
    E, L = 128, 24
    r = np.random.RandomState(4)
    block = PMMABlock(E, 2, mm=mm, dropout_rate=0.0)
    for p in block.parameters():
        p.data = torch.from_numpy(0.1 * r.randn(*p.shape).astype(np.float32))
    inputs = [_t(r.randn(2, L, E).astype(np.float32)) for _ in range(2 if mm else 1)]
    names = ([f"attn.{n}.weight" for n in ("query", "key", "value", "query_mol", "key_mol",
                                          "value_mol")] if mm
             else [f"attn.{n}.weight" for n in ("query", "key", "value")])

    def grads():
        block.zero_grad(set_to_none=True)
        p, m, _, _ = block(*inputs)
        ((p * p).sum() + (0.0 if m is None else (m * m * 0.5).sum())).backward()
        return {n: block.get_parameter(n).grad.clone() for n in names}

    got = grads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "paired_attention", attention.paired_attention_plain)
        mp.setattr(attention, "self_attention", attention.self_attention_plain)
        ref = grads()
    for n in names:
        assert got[n].abs().max() > 0, n
        torch.testing.assert_close(got[n], ref[n], rtol=2e-5, atol=1e-7, msg=n)


def test_cpu_tensors_take_the_differentiable_plain_version():
    B, H, L, S, D = 1, 2, 8, 12, 64
    q, k, v, qo = (x.requires_grad_() for x in map(
        _t, _operands([(B, H, L, D), (B, H, S, D), (B, H, S, D), (B, H, L, D)], seed=5)))
    attention.reset_launch_counts()
    s, g = attention.paired_attention(q, k, v, qo)
    (s.sum() + g.sum()).backward()
    assert all(t.grad is not None and t.grad.abs().max() > 0 for t in (q, k, v, qo))
    assert set(attention.LAUNCHES.values()) == {0}
