"""The port's hand-written CUDA kernels on a card: each against its plain
PyTorch version, the wrappers' refusals, and the serving path's launch counts.

Every test here carries the ``cuda`` marker and skips without a card.  The
file imports neither JAX nor the JAX package, so on a machine with a card and
no JAX it runs on its own:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import torch

from druglamp_tpu_torch.kernels import attention

pytestmark = pytest.mark.cuda


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,L,S,D,paired", [
    (32, 4, 256, 256, 64, True), (32, 4, 256, 256, 128, False),
    (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False),
])
def test_kernel_matches_plain(cuda, dtype, B, H, L, S, D, paired):
    """f32: atol = rtol = 1e-5.  bf16: one bf16 ulp at the output's largest
    magnitude (the kernel keeps the probabilities in f32 where the plain
    version rounds them to bf16)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    rand = lambda n: torch.randn(B, H, n, D, generator=g, device=cuda).to(dtype)  # noqa: E731
    q, k, v, qo = rand(L), rand(S), rand(S), rand(L)
    before = dict(attention.LAUNCHES)
    if paired:
        name = "paired_attention_fwd"
        got, ref = attention.paired_attention(q, k, v, qo), attention.paired_attention_plain(q, k, v, qo)
    else:
        name = "self_attention_fwd"
        got, ref = (attention.self_attention(q, k, v),), (attention.self_attention_plain(q, k, v),)
    torch.cuda.synchronize()
    assert attention.LAUNCHES[name] == before[name] + 1
    for a, b in zip(got, ref):
        assert a.dtype == dtype and a.device.type == "cuda"
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        else:
            assert (a.float() - b.float()).abs().max().item() <= _bf16_ulp(b.float().abs().max().item())


def test_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.zeros(1, 1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attention.self_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        attention.paired_attention_core(q, q, q, q)
    q64 = torch.zeros(1, 1, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        attention.self_attention(q64, q64, q64)


def test_serving_path_launches_the_kernels(cuda):
    """Full-width Config() in bf16: one chunk of 3 pairs (padded to 32) runs
    4 paired and 2 self launches and agrees with the plain attention."""
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.serve import Predictor

    cfg = Config()
    model = build_model("DrugLAMPwoLLM", cfg, generator=torch.Generator().manual_seed(0))
    predictor = Predictor(model, cfg, batch_size=32, device=cuda)
    pairs = [("CC(=O)OC1=CC=CC=C1C(=O)O", "MKTAYIAKQRQISFVKSHFSRQ" * 10),
             ("CN1C=NC2=C1C(=O)N(C(=O)N2C)C", "MSEQNNTEMTFQIQRIYTKD" * 3),
             ("CC(=O)NC1=CC=C(C=C1)O", "ACDEFGHIKLMNPQRSTVWY" * 51)]
    attention.reset_launch_counts()
    probs = predictor.predict_pairs(pairs)
    assert attention.LAUNCHES == {"paired_attention_fwd": 4, "self_attention_fwd": 2}
    assert probs.shape == (3,) and np.all(np.isfinite(probs))
    saved = attention.paired_attention, attention.self_attention
    attention.paired_attention = attention.paired_attention_plain
    attention.self_attention = attention.self_attention_plain
    try:
        ref = predictor.predict_pairs(pairs)
    finally:
        attention.paired_attention, attention.self_attention = saved
    np.testing.assert_allclose(probs, ref, rtol=0, atol=2e-2)
