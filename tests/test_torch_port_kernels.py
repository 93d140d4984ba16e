"""The port's attention module (druglamp_tpu_torch/kernels/attention.py) against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_kernels.py runs them, plus the dispatch rules, the operand checks
and the build's library naming.  The CUDA kernels themselves are tested on a
card by tests/test_torch_port_cuda.py."""

import math
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import druglamp_tpu.kernels.paired_attention_pallas as pk
from druglamp_tpu.kernels.paired_attention import _attn
from druglamp_tpu_torch.kernels import attention, build


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
    assert attention.LAUNCHES == {"paired_attention_fwd": 0, "self_attention_fwd": 0}


def _ok_operands(D=64, dtype=torch.float32):
    return [torch.zeros(2, 2, 8, D, dtype=dtype), torch.zeros(2, 2, 10, D, dtype=dtype),
            torch.zeros(2, 2, 10, D, dtype=dtype), torch.zeros(2, 2, 8, D, dtype=dtype)]


@pytest.mark.parametrize("case,match", [
    ("head_dim", "head dim 32"),
    ("dtype", "dtype"),
    ("contiguous", "contiguous"),
    ("shape", "shape mismatch"),
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
    with pytest.raises(ValueError, match=match):
        attention.check_operands(*ops)


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
