"""The port's hand-written CUDA kernels on a card: each forward and backward
against its plain PyTorch version, the wrappers' refusals, the gradients that
reach PMMA's projections through the kernels, and the launch counts of the
serving path and of a full-width train step.  Also the f32 numerics on the
card: forwards in true f32 under torch's default TF32 settings, and f32
train steps that repeat bit for bit.

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
    (1, 4, 256, 256, 128, False), (2, 3, 200, 130, 128, False), (2, 2, 70, 300, 128, False),
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
    (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False), (2, 3, 200, 130, 128, False),
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


@pytest.mark.parametrize("B", [32, 16])
def test_bf16_self_forward_is_deterministic(cuda, B):
    """Two launches of the bf16 self forward on the same inputs give
    bit-identical outputs and lse."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(B, 4, 256, 128, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    (o1,), lse1 = attention.launch_forward(q, k, v, None, with_lse=True)
    (o2,), lse2 = attention.launch_forward(q, k, v, None, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


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
@pytest.mark.parametrize("B,N,C", [(1, 64, 64), (16, 512, 128), (64, 512, 128), (3, 256, 64)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcn_packed_kernel_is_deterministic(cuda, dtype):
    """Two launches on the same inputs at the training shape give
    bit-identical outputs (each warp sums its own row in a fixed order)."""
    from druglamp_tpu_torch.kernels import gcn

    packed, nrm, n2r, x, _ = _packed_case(cuda, 16, 512, 128, dtype, seed=5)
    first = gcn.gcn_packed_matmul(packed, nrm, n2r, x)
    second = gcn.gcn_packed_matmul(packed, nrm, n2r, x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
    shifted = torch.zeros(x.numel() + 1, device=cuda)[1:].view(x.shape)   # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        gcn.gcn_packed_matmul(packed, nrm, n2r, shifted)
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


# --- f32 numerics on the card: TF32 and determinism -----------------------------------------

def _f32_trainer(cuda, name="DrugLAMP"):
    """(model, state, compact batch of 16) at full width in f32, seed 0."""
    import dataclasses

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.encoding import compact_batch
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.utils.synthetic import make_batch

    cfg = Config()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, compute_dtype="float32"))
    model = build_model(name, cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
    host = make_batch(cfg, 16, seed=0, n_drug_feature=384, n_prot_feature=640)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in compact_batch(host, (host["d_fill"] == 0).sum(1)).items()}
    return cfg, model, TrainState.create(model), batch


@pytest.mark.parametrize("matmul", ["highest", "high"])
def test_f32_forwards_ignore_the_tf32_settings(cuda, matmul):
    """ProteinCNN and DrugLAMP in f32 under torch's default TF32 settings
    (cuDNN TF32 on), and under a caller's matmul precision "high", within
    2e-5 of the same forwards with TF32 off (the forward-score tolerance of
    docs/PARITY.md); the caller's settings are unchanged afterwards."""
    from druglamp_tpu_torch.data.encoding import decode_batch
    from druglamp_tpu_torch.nn.protein_cnn import ProteinCNN

    cfg, model, _, batch = _f32_trainer(cuda)
    model.eval()
    decoded = decode_batch(dict(batch))
    cnn = ProteinCNN(embedding_dim=128, num_filters=(128,) * 3, kernel_size=(3, 6, 9),
                     dtype=torch.float32)
    cnn.init_weights(torch.Generator().manual_seed(1))
    cnn = cnn.to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(6)
    v = torch.randint(0, 26, (16, 2304), generator=g, device=cuda)
    fill = (torch.rand(16, 2304, generator=g, device=cuda) < 0.1).float()
    with torch.no_grad():
        ref = cnn(v, fill), model(decoded)["score"]
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision(matmul)
        try:
            got = cnn(v, fill), model(decoded)["score"]
            kept = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
    assert kept == (True, matmul)
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 2e-5


@pytest.mark.parametrize("tf32_second", [False, True], ids=["tf32_off", "tf32_second"])
def test_two_f32_steps_are_bit_identical(cuda, tf32_second):
    """Two f32 train steps of DrugLAMP from one seed (dropout 0.1 from one
    generator seed, lr 1e-4): bit-identical parameters and gradients, leaf by
    leaf.  The steps run under cuDNN's deterministic algorithms and in true
    f32, forward and backward, whatever the caller's TF32 settings: the
    second step may run under torch's default cuDNN TF32 and a caller's
    matmul precision "high"."""
    from druglamp_tpu_torch.train.steps import make_train_step

    runs = []
    for tf32 in (False, tf32_second):
        _, model, state, batch = _f32_trainer(cuda)
        step = make_train_step(model, False, False)
        torch.backends.cudnn.allow_tf32 = tf32
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        try:
            step(state, batch, torch.Generator(device=cuda).manual_seed(0), 1e-4)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        runs.append({n: (p.detach().clone(), p.grad.clone()) for n, p in model.named_parameters()})
    assert runs[0].keys() == runs[1].keys()
    for n, (p, g) in runs[0].items():
        assert torch.equal(p, runs[1][n][0]) and torch.equal(g, runs[1][n][1]), n


def test_f32_step_runs_under_deterministic_algorithms(cuda, monkeypatch):
    """One f32 step under torch.use_deterministic_algorithms(True): no op of
    the step lacks a deterministic implementation (torch would raise)."""
    from druglamp_tpu_torch.train.steps import make_train_step

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    _, model, state, batch = _f32_trainer(cuda)
    step = make_train_step(model, False, False)
    torch.use_deterministic_algorithms(True)
    try:
        out = step(state, batch, torch.Generator(device=cuda).manual_seed(0), 1e-4)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.isfinite(out.cls_loss)


# --- the full DrugLAMP2C2P recipe: the SSL and CM gates, the Trainer ----------------------

def _full_gate(cuda, dtype="bfloat16", dropout=None):
    """(model, state, step, batch) for DrugLAMP2C2P at full width, seed 0,
    packed GCN: the full-gate step (ssl, cm, calibrate) and a compact batch
    of 16 whose CM ground truth has positives, negatives and fallback rows
    (proteins 0–3 with a positive, protein 4 negatives only)."""
    import dataclasses

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.encoding import compact_batch
    from druglamp_tpu_torch.data.loader import build_cm_arrays
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_train_step
    from druglamp_tpu_torch.utils.synthetic import make_batch

    cfg = Config()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, compute_dtype=dtype),
                              pmma_dropout=cfg.pmma_dropout if dropout is None else dropout)
    model = build_model("DrugLAMP2C2P", cfg, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, True, True, calibrate=True)
    host = make_batch(cfg, 16, seed=0, n_drug_feature=384, n_prot_feature=640)
    batch = compact_batch(host, (host["d_fill"] == 0).sum(1))
    t = np.arange(16)
    batch["labels"] = ((t % 3 == 0) & (t % 5 != 4)).astype(np.float32)
    cm = build_cm_arrays(t % 5, t % 7, batch["labels"])
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    batch["cm"] = {k: torch.from_numpy(v).to(cuda) for k, v in cm.items()}
    return model, TrainState.create(model, True, True), step, batch


def test_full_gate_step_launches_the_kernels(cuda, monkeypatch):
    """One bf16 full-gate step: 4/2 attention forward and backward launches
    (only the cls loss reaches PMMA), 3 GCN forward and 9 GCN backward (one
    per loss); finite losses, the CM weight a power of 10 times its start."""
    from druglamp_tpu_torch.kernels import gcn

    monkeypatch.setenv("DRUGLAMP_PACKED_GCN", "1")
    model, state, step, batch = _full_gate(cuda)
    attention.reset_launch_counts()
    gcn.reset_launch_counts()
    out = step(state, batch, torch.Generator(device=cuda).manual_seed(0), 1e-4, 3e-5, 3e-5, 0.5,
               1e-3)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == {"paired_attention_fwd": 4, "self_attention_fwd": 2,
                                  "paired_attention_bwd": 4, "self_attention_bwd": 2}
    assert gcn.LAUNCHES == {"gcn_packed_matmul": 3, "gcn_packed_matmul_bwd": 9}
    assert all(torch.isfinite(x) for x in (out.cls_loss, out.ssl_loss, out.cm_loss))
    k = math.log10(float(out.cm_weight) / 1e-3)
    assert abs(k - round(k)) < 1e-6


def test_f32_full_gate_through_the_kernels_matches_plain(cuda, monkeypatch):
    """The f32 full-gate step's losses and per-loss gradients (dropout 0, the
    same MLM draws) through the kernels and through the plain attention and
    GCN: losses 1e-5, gradients rtol 5e-3 / atol 5e-5, leaf by leaf."""
    from druglamp_tpu_torch.data.encoding import decode_batch
    from druglamp_tpu_torch.kernels import gcn
    from druglamp_tpu_torch.train import steps

    monkeypatch.setenv("DRUGLAMP_PACKED_GCN", "1")
    runs = []
    for plain in (False, True):
        model, _, _, batch = _full_gate(cuda, "float32", dropout=0.0)
        model.to(cuda).train()
        with monkeypatch.context() as mp:
            if plain:
                mp.setattr(attention, "paired_attention", attention.paired_attention_plain)
                mp.setattr(attention, "self_attention", attention.self_attention_plain)
                mp.setattr(gcn, "gcn_packed_matmul", gcn.gcn_packed_plain)
            with steps.train_numerics():
                *losses, _, w, grads = steps.loss_gradients(
                    model, decode_batch(dict(batch)), torch.Generator(device=cuda).manual_seed(0),
                    True, True, True, 0.5, torch.ones((), device=cuda))
        runs.append(([float(x) for x in losses], float(w), grads))
    (lk, wk, gk), (lp, wp, gp) = runs
    assert max(abs(a - b) for a, b in zip(lk, lp)) <= 1e-5 and wk == wp
    for loss in ("cls", "ssl", "cm"):
        for a, b in zip(gk[loss], gp[loss]):
            torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-5)


def test_two_f32_full_gate_steps_are_bit_identical(cuda, monkeypatch):
    monkeypatch.setenv("DRUGLAMP_PACKED_GCN", "1")
    runs = []
    for _ in range(2):
        model, state, step, batch = _full_gate(cuda, "float32")
        out = step(state, batch, torch.Generator(device=cuda).manual_seed(0), 1e-4, 3e-5, 3e-5,
                   0.5, 1.0)
        runs.append(({k: v.clone() for k, v in model.state_dict().items()},
                     [float(out.cls_loss), float(out.ssl_loss), float(out.cm_loss)]))
    (s1, l1), (s2, l2) = runs
    assert l1 == l2
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


def test_trainer_resume_is_bit_identical(cuda, tmp_path, monkeypatch):
    """A short DrugLAMP2C2P Trainer (full width, 64-node graphs, 9×32
    protein tiles, bf16, packed GCN) over 3 epochs (cls; ssl + cm +
    calibrate; cm) on the card against one that restores the epoch-2
    ckpt_last.pt into a model with other weights and trains epoch 3: equal
    checkpoints, leaf by leaf."""
    import shutil

    from druglamp_tpu_torch.config import RSConfig, SolverConfig
    from druglamp_tpu_torch.data.cache import EmbeddingCache
    from druglamp_tpu_torch.data.dataset import DTIDataset
    from druglamp_tpu_torch.data.device_data import DeviceDataStore
    from druglamp_tpu_torch.data.device_store import DeviceEmbeddingStore
    from druglamp_tpu_torch.data.loader import BatchLoader
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.trainer import Trainer
    from druglamp_tpu_torch.utils.synthetic import tiny_config

    monkeypatch.setenv("DRUGLAMP_PACKED_GCN", "1")
    cfg = tiny_config(n_hidden=128, max_nodes=64, site_seq=32,
                      solver=SolverConfig(max_epoch=3, batch_size=4, ckpt_every=1),
                      rs=RSConfig(ssl=True, cm=True, init_epoch=2, epoch_step=2))
    r = np.random.RandomState(0)
    smiles = ["C" * 20, "CCO" * 8, "c1ccccc1" + "CC" * 8, "CN" * 12, "OCC(O)CO" * 3]
    prots = ["".join("ACDEFGHIKLMNPQRSTVWY"[i] for i in r.randint(0, 20, n)) for n in (40, 60, 90)]
    d = tmp_path / "toy" / "random"
    d.mkdir(parents=True)
    for name, n in (("train.csv", 24), ("val.csv", 8), ("test.csv", 8)):
        rows = [f"{smiles[r.randint(5)]},{prots[r.randint(3)]},{i % 2}" for i in range(n)]
        (d / name).write_text("\n".join(["SMILES,Protein,Y"] + rows) + "\n")
    kw = dict(max_nodes=64, seq_len=cfg.protein.seq_len, max_prot_resis=cfg.protein.max_resis)
    train = DTIDataset(str(tmp_path), "toy", "random", "train.csv", **kw)
    val = DTIDataset(str(tmp_path), "toy", "random", "val.csv", table=train.table, **kw)
    test = DTIDataset(str(tmp_path), "toy", "random", "test.csv", table=train.table, **kw)
    cache = EmbeddingCache(str(tmp_path / "emb"), "toy")
    for o in range(train.table.n_drug):
        cache.put_drug(o, r.randn(12, 384))
    for o in range(train.table.n_prot):
        cache.put_prot(o, r.randn(30, 640))
    emb = DeviceEmbeddingStore.build(train.table, cache, max_drug_tokens=64,
                                     max_prot_len=cfg.protein.max_resis + 2).tree
    data = DeviceDataStore.build(train.table, 64, cfg.protein.seq_len, True, True)
    loaders = (BatchLoader(train, 4, True, True, seed=1),
               BatchLoader(val, 4, False, False),
               BatchLoader(test, 4, False, False))

    def trainer(work, seed):
        model = build_model("DrugLAMP2C2P", cfg, generator=torch.Generator().manual_seed(seed))
        t = Trainer(model, cfg, *loaders, work_dir=str(tmp_path / work), embed_store=emb,
                    device_data=data)
        t.patience = 3
        return t, TrainState.create(model, True, True)

    full, state = trainer("full", 0)
    save = full._save

    def keep_epoch2(path, snapshot):
        save(path, snapshot)
        if path.endswith("ckpt_last.pt") and full.epoch == 2:
            shutil.copy(path, tmp_path / "epoch2.pt")

    full._save = keep_epoch2
    full.fit(state, 7)
    (tmp_path / "resumed").mkdir()
    shutil.copy(tmp_path / "epoch2.pt", tmp_path / "resumed" / "ckpt_last.pt")
    resumed, state = trainer("resumed", 1)
    resumed.restore(str(tmp_path / "resumed" / "ckpt_last.pt"), state)
    resumed.fit(state, 7, start_epoch=resumed.epoch + 1)
    a = torch.load(tmp_path / "full" / "ckpt_last.pt", weights_only=True)
    b = torch.load(tmp_path / "resumed" / "ckpt_last.pt", weights_only=True)
    assert a["host"] == b["host"] and a["host"]["epoch"] == 3
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    for opt in ("opt_cls", "opt_ssl", "opt_cm"):
        sa, sb = a["optim"][opt]["state"], b["optim"][opt]["state"]
        assert sa and set(sa) == set(sb)
        assert all(torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))
                   for i in sa for k in sa[i])
