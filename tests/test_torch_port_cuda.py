"""The port's hand-written CUDA kernels on a card: each forward and backward
against its plain PyTorch version, the wrappers' refusals, the gradients that
reach PMMA's projections through the kernels, and the launch counts of the
serving path and of a full-width train step.

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
    (16, 4, 256, 256, 64, True), (16, 4, 256, 256, 128, False),
    (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False),
])
def test_kernel_matches_plain(cuda, dtype, B, H, L, S, D, paired):
    """Serving (B=32), training (B=16) and ragged shapes.  f32 (FMA kernel):
    atol = rtol = 1e-5.  bf16 (tensor-core kernel): one bf16 ulp at the
    output's largest magnitude (the kernel keeps ~16 bits of the
    probabilities, P_hi + P_lo, where the plain version rounds them to
    bf16)."""
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


@pytest.mark.parametrize("B,H,L,S,D,paired", [
    (32, 4, 256, 256, 64, True), (32, 4, 256, 256, 128, False),
    (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False),
])
def test_bf16_forward_lse_matches_plain(cuda, B, H, L, S, D, paired):
    """The tensor-core forward's (NQ, B·H, L) log-sum-exp, which the backward
    kernels read, within 1e-5 of the plain one of the scaled f32 logits."""
    g = torch.Generator(device=cuda).manual_seed(2)
    def rand(n):
        return torch.randn(B, H, n, D, generator=g, device=cuda).to(torch.bfloat16)

    q, k, v = rand(L), rand(S), rand(S)
    qs = [q, rand(L)] if paired else [q]
    _, lse = attention.launch_forward(q, k, v, qs[1] if paired else None, with_lse=True)
    torch.cuda.synchronize()
    ref = torch.stack([torch.logsumexp(torch.matmul(x.float(), k.float().transpose(-1, -2))
                                       / math.sqrt(D), -1).reshape(B * H, L) for x in qs])
    assert lse.shape == (len(qs), B * H, L) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref, atol=1e-5, rtol=0)


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
    assert attention.LAUNCHES == {"paired_attention_fwd": 4, "self_attention_fwd": 2,
                                  "paired_attention_bwd": 0, "self_attention_bwd": 0}
    assert probs.shape == (3,) and np.all(np.isfinite(probs))
    saved = attention.paired_attention, attention.self_attention
    attention.paired_attention = attention.paired_attention_plain
    attention.self_attention = attention.self_attention_plain
    try:
        ref = predictor.predict_pairs(pairs)
    finally:
        attention.paired_attention, attention.self_attention = saved
    np.testing.assert_allclose(probs, ref, rtol=0, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,L,S,D,paired", [
    (16, 4, 256, 256, 64, True), (16, 4, 256, 256, 128, False),
    (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False),
    (2, 3, 150, 70, 64, True), (2, 2, 130, 100, 128, False),
])
def test_backward_kernel_matches_plain(cuda, dtype, B, H, L, S, D, paired):
    """Gradients through the autograd Function (forward and backward kernels)
    against the plain backward, with incoming gradients made non-contiguous
    the way _merge_heads makes them, at the training and ragged shapes (the
    last two with S not a multiple of 64 and L > S).  f32: atol = rtol =
    2e-5.  bf16: against the plain backward run in f32 on the same bf16
    inputs, within one bf16 ulp at each gradient's largest magnitude (the
    tensor-core kernels accumulate in f32, feed P and dS as bf16 hi + lo,
    and round once)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    rand = lambda n: torch.randn(B, H, n, D, generator=g, device=cuda).to(dtype)  # noqa: E731
    ins = [rand(L), rand(S), rand(S)] + ([rand(L)] if paired else [])
    dos = [torch.randn(B, L, H, D, generator=g, device=cuda).to(dtype).transpose(1, 2)
           for _ in range(2 if paired else 1)]
    assert not dos[0].is_contiguous()
    leaves = [t.clone().requires_grad_() for t in ins]
    before = dict(attention.LAUNCHES)
    outs = attention.paired_attention(*leaves) if paired else (attention.self_attention(*leaves),)
    got = torch.autograd.grad(outs, leaves, dos)
    torch.cuda.synchronize()
    name = "paired_attention_bwd" if paired else "self_attention_bwd"
    assert attention.LAUNCHES[name] == before[name] + 1
    plain = attention.paired_attention_bwd_plain if paired else attention.self_attention_bwd_plain
    if dtype == torch.float32:
        for a, b in zip(got, plain(*ins, *dos)):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    else:
        ref = plain(*(t.float() for t in ins), *(t.float() for t in dos))
        for a, b in zip(got, ref):
            assert a.dtype == torch.bfloat16
            assert (a.float() - b).abs().max().item() <= _bf16_ulp(b.abs().max().item())


@pytest.mark.parametrize("D,paired", [(64, True), (128, False)])
def test_bf16_backward_is_deterministic(cuda, D, paired):
    """Two bf16 backward launches on the same inputs at the training shapes
    (B=16, H=4, L=S=256) give bit-identical gradients: the kernels sum in a
    fixed order and use no atomics."""
    g = torch.Generator(device=cuda).manual_seed(3)
    rand = lambda: torch.randn(16, 4, 256, D, generator=g, device=cuda).to(torch.bfloat16)  # noqa: E731
    q, k, v = rand(), rand(), rand()
    q_o = rand() if paired else None
    dos = [rand() for _ in range(2 if paired else 1)]
    outs, lse = attention.launch_forward(q, k, v, q_o, with_lse=True)
    first = attention.launch_backward(q, k, v, q_o, outs, lse, dos)
    second = attention.launch_backward(q, k, v, q_o, outs, lse, dos)
    torch.cuda.synchronize()
    assert len(first) == (4 if paired else 3)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_projection_gets_a_gradient_through_the_kernels(cuda, dtype):
    """One backward through a paired and a self PMMA block on the card: every
    query/key/value weight gets a non-zero gradient (the forward kernels'
    outputs are attached to autograd), and the backward kernels ran."""
    from druglamp_tpu_torch.nn.pmma import PMMABlock

    torch.manual_seed(0)
    paired = PMMABlock(256, 4, mm=True, dropout_rate=0.0, dtype=dtype).to(cuda)
    single = PMMABlock(512, 4, mm=False, dropout_rate=0.0, dtype=dtype).to(cuda)
    prot, mol = (torch.randn(2, 256, 256, device=cuda) for _ in range(2))
    attention.reset_launch_counts()
    p, m, _, _ = paired(prot, mol)
    x, _, _, _ = single(torch.cat([p, m], dim=-1))
    x.float().square().mean().backward()
    torch.cuda.synchronize()
    assert attention.LAUNCHES == {"paired_attention_fwd": 2, "self_attention_fwd": 1,
                                  "paired_attention_bwd": 2, "self_attention_bwd": 1}
    names = [f"attn.{n}.weight" for n in ("query", "key", "value", "query_mol", "key_mol",
                                         "value_mol")]
    for block, ns in ((paired, names), (single, names[:3])):
        for n in ns:
            grad = block.get_parameter(n).grad
            assert grad is not None and torch.isfinite(grad).all() and grad.abs().max() > 0, n


def test_full_width_train_step_launches_the_kernels(cuda):
    """Config() at full width, bf16, batch 16 (compact, decoded on the card):
    one step launches paired 4, self 2 forward and 4, 2 backward kernels."""
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.encoding import compact_batch
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_train_step
    from druglamp_tpu_torch.utils.synthetic import make_batch

    cfg = Config()
    model = build_model("DrugLAMP", cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
    host = make_batch(cfg, 16, seed=0, n_drug_feature=384, n_prot_feature=640)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in compact_batch(host, (host["d_fill"] == 0).sum(1)).items()}
    state, step = TrainState.create(model), make_train_step(model, False, False)
    attention.reset_launch_counts()
    out = step(state, batch, torch.Generator(device=cuda).manual_seed(0), 1e-4)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == {"paired_attention_fwd": 4, "self_attention_fwd": 2,
                                  "paired_attention_bwd": 4, "self_attention_bwd": 2}
    assert torch.isfinite(out.cls_loss) and out.probs.shape == (16,)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


# --- the packed-adjacency GCN kernel (csrc/gcn_packed.cu) ---------------------------------

def _packed_case(cuda, B, N, C, dtype, seed=0):
    """Molecule-like bits (ragged n_atoms, bonds among real atoms, the
    universal self-loop), its scales, x and dy on the card."""
    from druglamp_tpu_torch.data.encoding import pack_adjacency
    from druglamp_tpu_torch.kernels import gcn

    r = np.random.RandomState(seed)
    n_atoms = r.randint(N // 8, N // 2, size=B)
    adj = np.zeros((B, N, N), np.uint8)
    ar = np.arange(N)
    for b in range(B):
        for _ in range(2 * n_atoms[b]):
            i, j = r.randint(0, n_atoms[b], 2)
            adj[b, i, j] = adj[b, j, i] = 1
        adj[b, ar, ar] = 1
    packed = torch.from_numpy(pack_adjacency(adj)).to(cuda)
    real = torch.from_numpy((ar[None, :] < n_atoms[:, None]).astype(np.float32)).to(cuda)
    nrm = torch.rsqrt(torch.clamp(gcn.packed_degrees(packed, real), min=1.0))
    x = torch.from_numpy(r.randn(B, N, C).astype(np.float32)).to(cuda).to(dtype)
    dy = torch.from_numpy(r.randn(B, N, C).astype(np.float32)).to(cuda)
    return packed, nrm, nrm * nrm * real, x, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,C", [(16, 512, 128), (3, 256, 64)])
def test_gcn_packed_kernel_matches_plain(cuda, dtype, B, N, C):
    """Forward and backward (through the autograd Function: the backward is
    a second launch on dy cast to x's dtype) against the plain version, and
    against the plain version applied to dy (S is symmetric).  f32: atol =
    rtol = 1e-5.  bf16 x: the products with A are exact and only the order
    of the f32 sums differs, so y within 1e-5 of its largest magnitude; dx
    is rounded to bf16 once, one bf16 ulp of its largest magnitude."""
    from druglamp_tpu_torch.kernels import gcn

    packed, nrm, n2r, x, dy = _packed_case(cuda, B, N, C, dtype)
    leaf = x.clone().requires_grad_()
    before = dict(gcn.LAUNCHES)
    y = gcn.gcn_packed_matmul(packed, nrm, n2r, leaf)
    (dx,) = torch.autograd.grad(y, leaf, dy)
    torch.cuda.synchronize()
    assert gcn.LAUNCHES["gcn_packed_matmul"] == before["gcn_packed_matmul"] + 1
    assert gcn.LAUNCHES["gcn_packed_matmul_bwd"] == before["gcn_packed_matmul_bwd"] + 1
    ref = gcn.gcn_packed_plain(packed, nrm, n2r, x)
    ref_dx = gcn.gcn_packed_plain(packed, nrm, n2r, dy.to(dtype))      # S·dy, f32
    assert y.dtype == torch.float32 and dx.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dx, ref_dx, atol=1e-5, rtol=1e-5)
    else:
        assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
        assert (dx.float() - ref_dx).abs().max().item() <= _bf16_ulp(ref_dx.abs().max().item())


def test_gcn_packed_kernel_raises_instead_of_falling_back(cuda):
    from druglamp_tpu_torch.kernels import gcn

    packed, nrm, n2r, x, _ = _packed_case(cuda, 2, 256, 64, torch.float32)
    cut = (packed[:, :96, :12].contiguous(), nrm[:, :96].contiguous(),
           n2r[:, :96].contiguous(), x[:, :96].contiguous())
    before = dict(gcn.LAUNCHES)
    with pytest.raises(ValueError, match="multiple of 64"):
        gcn.gcn_packed_matmul(*cut)
    with pytest.raises(ValueError, match="C=32"):
        gcn.gcn_packed_matmul(packed, nrm, n2r, x[..., :32].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        gcn.gcn_packed_matmul(packed, nrm, n2r, x.half())
    assert gcn.LAUNCHES == before


def test_packed_gate_keeps_the_adjacency_packed_and_launches_the_kernel(cuda, monkeypatch):
    """DRUGLAMP_PACKED_GCN=1 on a CUDA batch: decode_batch (auto) keeps the
    adjacency packed, and a full-width train step of DrugLAMPwoLLM launches
    the GCN kernel 3 times forward and 3 times backward; with the gate off
    the adjacency is dense and the kernel does not run."""
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.encoding import compact_batch, decode_batch
    from druglamp_tpu_torch.kernels import gcn
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_train_step
    from druglamp_tpu_torch.utils.synthetic import make_batch

    cfg = Config()
    host = make_batch(cfg, 16, seed=0, n_drug_feature=384, n_prot_feature=640)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in compact_batch(host, (host["d_fill"] == 0).sum(1)).items()}
    monkeypatch.setenv("DRUGLAMP_PACKED_GCN", "0")
    assert not isinstance(decode_batch(dict(batch))["drug_adj"], dict)
    monkeypatch.setenv("DRUGLAMP_PACKED_GCN", "1")
    decoded = decode_batch(dict(batch))
    assert isinstance(decoded["drug_adj"], dict)
    assert decoded["drug_adj"]["packed"].shape == (16, 512, 64)
    model = build_model("DrugLAMPwoLLM", cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
    state, step = TrainState.create(model), make_train_step(model, False, False)
    gcn.reset_launch_counts()
    out = step(state, batch, torch.Generator(device=cuda).manual_seed(0), 1e-4)
    torch.cuda.synchronize()
    assert gcn.LAUNCHES == {"gcn_packed_matmul": 3, "gcn_packed_matmul_bwd": 3}
    assert torch.isfinite(out.cls_loss)
    grads = [model.get_parameter(f"drug_extractor.layer_{i}.graph.weight").grad for i in range(3)]
    assert all(g is not None and g.abs().max() > 0 for g in grads)
