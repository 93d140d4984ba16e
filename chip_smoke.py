#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``druglamp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  Phases, each
printing its own lines; any failure exits non-zero and prints no result:

1. device  — needs ``torch.cuda.is_available()``; prints the card's name and
   ``nvidia-smi`` name and power limit; TF32 is switched off for matmuls and
   cuDNN, so the f32 comparisons below are true f32.
2. build   — compiles every ``druglamp_tpu_torch/csrc/*.cu`` with nvcc for
   sm_90a (one nvcc per source, in parallel) and prints the seconds and the
   ptxas report (registers, shared memory, spills).
3. kernels — holds each kernel against its plain PyTorch version on the same
   inputs: the forwards at the serving shapes (B=32, H=4, L=S=256; D=64
   paired, D=128 self) and at ragged small shapes, in f32 (atol = rtol =
   1e-5) and bf16 (|err| ≤ one bf16 ulp at the output's largest magnitude:
   the kernel keeps the probabilities in f32 where the plain version rounds
   them to bf16); the backwards, through the autograd Functions with incoming
   gradients made non-contiguous as ``_merge_heads`` makes them, at the
   training shapes (B=16) and the same ragged shapes, in f32 (atol = rtol =
   2e-5) and bf16 (one bf16 ulp at each gradient's largest magnitude of the
   plain backward run in f32 on the same bf16 inputs).
4. serve   — ``Predictor`` at the default full-width ``Config()`` (bf16),
   with seeded weights and BatchNorm running stats taken from the first
   chunk, scores 64 pairs (two chunks of 32) through the kernels; asserts 4
   paired and 2 self launches per chunk, probabilities finite in [0, 1],
   and agreement with the same
   Predictor run through the plain attention on the card (bf16, and again
   at f32); runs ``return_attn=True`` once.
5. timing  — CUDA events, warm-up then the median of repeated runs of many
   launches: each kernel, its plain version, and the yardstick
   ``F.scaled_dot_product_attention`` (two calls for paired; timed here, never
   called by the port) at the serving shapes in bf16, beside the least time
   the card could take; Predictor pairs/s and peak device memory; a profiler
   table of the forward's device time by kernel (written to
   ``chiprun_out/serve_profile.txt`` as well).
6. train   — ``make_train_step`` (cls gate) on ``build_model("DrugLAMP",
   Config())`` at full width, bf16, seeded weights, one batch of 16 from
   ``make_batch`` put through ``compact_batch`` and decoded on the card:
   10 steps at lr 1e-4, asserting 4 paired / 2 self forward and 4 / 2
   backward launches per step, finite losses and gradients, and non-zero
   gradients on every PMMA q/k/v weight.  Then the same step in f32 with
   dropout 0, through the kernels and through the plain attention (forward
   and backward), from the same weights: step-1 gradients within rtol 5e-3 /
   atol 5e-5 and 3 losses within 1e-5.
7. train timing — step time by CUDA events (3 warm-up steps, median of 5
   repetitions of 10 steps on the resident batch), pairs/s, peak device
   memory, the device-busy share of a step (kernel device time from the
   profiler over the step time; table in ``chiprun_out/train_profile.txt``),
   and each backward kernel beside its bound, its plain version and the
   yardstick ``F.scaled_dot_product_attention``'s backward (timed in turns
   with the kernel; its kernels' names show the backend it picked).

The second-to-last line is one JSON object with the kernel records; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DEVICE = "cuda"
TIMEOUT_S = 60

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Real drugs (SMILES) for the serving phase; proteins are generated from SEED.
SMILES = [
    "CC(=O)OC1=CC=CC=C1C(=O)O",                                  # aspirin
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",                              # caffeine
    "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O",                             # ibuprofen
    "CC(=O)NC1=CC=C(C=C1)O",                                     # paracetamol
    "CC1=C(C=C(C=C1)NC(=O)C2=CC=C(C=C2)CN3CCN(CC3)C)NC4=NC=CC(=N4)C5=CN=CC=C5",  # imatinib
    "CN(C)C(=N)N=C(N)N",                                         # metformin
    "COC1=C(C=C2C(=C1)N=CN=C2NC3=CC(=C(C=C3)F)Cl)OCCCN4CCOCC4",  # gefitinib
    "C1=CC=C(C=C1)C2=CC(=O)C3=C(C=C(C=C3O2)O)O",                 # chrysin
]
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(torch, fn, iters: int = 20, reps: int = 7, warmup: int = 3) -> float:
    """Median over ``reps`` of the mean time per call of ``iters`` back-to-back
    calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 2.0 ** -133


def make_operands(torch, g, B, H, L, S, D, dtype, paired: bool):
    def rand(n):
        return torch.randn(B, H, n, D, generator=g, device="cuda").to(dtype)
    q, k, v = rand(L), rand(S), rand(S)
    return (q, k, v, rand(L)) if paired else (q, k, v)


def kernel_checks(torch, attention):
    """Phase 3: max |kernel − plain| per case; fails outside tolerance."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # (B, H, L, S, D, paired); the ragged ones cover the other instantiations
        (32, 4, 256, 256, 64, True), (32, 4, 256, 256, 128, False),
        (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False),
    ]
    serve_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, L, S, D, paired in cases:
            ops = make_operands(torch, g, B, H, L, S, D, dtype, paired)
            if paired:
                got = attention.paired_attention(*ops)
                ref = attention.paired_attention_plain(*ops)
            else:
                got = (attention.self_attention(*ops),)
                ref = (attention.self_attention_plain(*ops),)
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
            peak = max(b.float().abs().max().item() for b in ref)
            if dtype == torch.float32:
                tol = 1e-5 + 1e-5 * peak
                ok = all(torch.allclose(a, b, atol=1e-5, rtol=1e-5) for a, b in zip(got, ref))
            else:
                tol = bf16_ulp(peak)
                ok = err <= tol
            name = "paired_attention_fwd" if paired else "self_attention_fwd"
            print(f"  {name} {str(dtype).split('.')[-1]} B={B} H={H} L={L} S={S} D={D}: "
                  f"max_abs_err {err:.3e} (tol {tol:.3e}, max |out| {peak:.3f})", flush=True)
            if not ok:
                fail(f"{name} disagrees with its plain version at {(B, H, L, S, D)} {dtype}")
            if dtype == torch.bfloat16 and (L, S) == (256, 256):
                serve_err[name] = err
    return serve_err


@contextlib.contextmanager
def plain_attention(attention):
    """Route the PMMA cores through the plain PyTorch versions, forward and
    backward (autograd differentiates the plain forward); comparison only."""
    saved = attention.paired_attention, attention.self_attention
    attention.paired_attention = attention.paired_attention_plain
    attention.self_attention = attention.self_attention_plain
    try:
        yield
    finally:
        attention.paired_attention, attention.self_attention = saved


def make_pairs(n: int):
    import numpy as np

    rng = np.random.RandomState(SEED)
    lengths = rng.randint(50, 1023, size=n)
    lengths[0] = 1022                                  # the longest the model keeps
    seqs = ["".join(rng.choice(list(AMINO), size=int(m))) for m in lengths]
    return [(SMILES[i % len(SMILES)], seqs[i]) for i in range(n)]


def make_predictor(torch, cfg, calib_pairs):
    """DrugLAMP with weights drawn from SEED.  The BatchNorm running stats are
    the batch statistics of ``calib_pairs`` (BatchNorm layers alone in train
    mode, momentum 1): with random weights the pairs' features differ little,
    and eval-mode BatchNorm with such stats spreads their scores over a wide
    range, so the end-to-end comparisons below can see a fault."""
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.nn.layers import TorchBatchNorm
    from druglamp_tpu_torch.serve import Predictor

    model = build_model("DrugLAMP", cfg, generator=torch.Generator().manual_seed(SEED))
    predictor = Predictor(model, cfg, batch_size=32, device=DEVICE)
    norms = [m for m in model.modules() if isinstance(m, TorchBatchNorm)]
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in predictor._featurize(calib_pairs).items()}
    for bn in norms:
        bn.momentum = 1.0
        bn.train()
    with torch.no_grad():
        model(batch)
    for bn in norms:
        bn.momentum = 0.1
        bn.eval()
    return predictor


def serve_checks(torch, attention):
    """Phase 4: returns (predictor, pairs, launch counts of the main path)."""
    import dataclasses

    import numpy as np

    from druglamp_tpu_torch.config import Config

    cfg = Config()
    pairs = make_pairs(64)
    chunks = math.ceil(len(pairs) / 32)
    predictor = make_predictor(torch, cfg, pairs[:32])
    n_params = sum(p.numel() for p in predictor.model.parameters())
    print(f"  DrugLAMP at Config(): n_hidden {cfg.n_hidden}, max_nodes {cfg.drug.max_nodes}, "
          f"seq_len {cfg.protein.seq_len}, PMMA {cfg.pmma.hidden_size}x{cfg.pmma.num_heads} heads, "
          f"{cfg.solver.compute_dtype}, {n_params} parameters", flush=True)

    attention.reset_launch_counts()
    probs = predictor.predict_pairs(pairs)
    torch.cuda.synchronize()
    launches = dict(attention.LAUNCHES)
    print(f"  main path: {len(pairs)} pairs in {chunks} chunks, launches {launches}", flush=True)
    want = {"paired_attention_fwd": 4 * chunks, "self_attention_fwd": 2 * chunks,
            "paired_attention_bwd": 0, "self_attention_bwd": 0}
    if launches != want:
        fail(f"kernel launches {launches}, expected {want}")
    if probs.shape != (len(pairs),) or not np.all(np.isfinite(probs)) \
            or probs.min() < 0 or probs.max() > 1:
        fail(f"probabilities not finite in [0, 1]: shape {probs.shape}")
    print(f"  probabilities: min {probs.min():.4f} max {probs.max():.4f} "
          f"mean {probs.mean():.4f} std {probs.std():.4f}", flush=True)

    # Same Predictor, attention through the plain versions on the card.  In
    # bf16 the kernel keeps the softmax probabilities in f32 where the plain
    # version rounds them to bf16, so attention outputs differ by up to one
    # bf16 ulp and the difference runs through a bf16 network: tolerance 2e-2
    # on a probability, about five bf16 ulps at 0.5.  In f32 the two differ
    # only in summation order: tolerance 2e-5, the forward-score tolerance of
    # docs/PARITY.md.
    with plain_attention(attention):
        ref = predictor.predict_pairs(pairs)
    err = float(np.abs(probs - ref).max())
    tol = 2e-2
    print(f"  bf16 kernels vs plain attention: max |Δp| {err:.3e} (tol {tol})", flush=True)
    if err > tol:
        fail("bf16 Predictor disagrees with its plain-attention run")

    cfg32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                compute_dtype="float32"))
    p32 = make_predictor(torch, cfg32, pairs[:32])
    got32 = p32.predict_pairs(pairs)
    with plain_attention(attention):
        ref32 = p32.predict_pairs(pairs)
    err32 = float(np.abs(got32 - ref32).max())
    print(f"  f32 kernels vs plain attention: max |Δp| {err32:.3e} (tol 2e-5); "
          f"bf16 vs f32 run max |Δp| {float(np.abs(probs - got32).max()):.3e}", flush=True)
    if err32 > 2e-5:
        fail("f32 Predictor disagrees with its plain-attention run")
    del p32

    probs5, attn = predictor.predict_pairs(pairs[:5], return_attn=True)
    want_shape = (5, 1, cfg.pmma.feat_len, cfg.drug.max_nodes)
    if attn is None or attn.shape != want_shape or not np.all(np.isfinite(attn)):
        fail(f"return_attn logits: {None if attn is None else attn.shape}, want {want_shape}")
    err5 = float(np.abs(probs5 - probs[:5]).max())
    print(f"  return_attn: logits {attn.shape}, probabilities vs the main run max |Δp| "
          f"{err5:.3e}", flush=True)
    if err5 > tol:
        fail("return_attn probabilities disagree with the main run")
    return predictor, pairs, launches


def kernel_record(torch, F, attention, name, paired, launches, max_abs_err):
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, H, L, S = 32, 4, 256, 256
    D = 64 if paired else 128
    ops = make_operands(torch, g, B, H, L, S, D, torch.bfloat16, paired)
    if paired:
        q, k, v, qo = ops
        kernel = lambda: attention.paired_attention(q, k, v, qo)          # noqa: E731
        plain = lambda: attention.paired_attention_plain(q, k, v, qo)     # noqa: E731
        library = lambda: (F.scaled_dot_product_attention(q, k, v),       # noqa: E731
                           F.scaled_dot_product_attention(qo, k, v))
        n_out, products = 2, 2
    else:
        q, k, v = ops
        kernel = lambda: attention.self_attention(q, k, v)                # noqa: E731
        plain = lambda: attention.self_attention_plain(q, k, v)           # noqa: E731
        library = lambda: F.scaled_dot_product_attention(q, k, v)         # noqa: E731
        n_out, products = 1, 1
    in_bytes = sum(t.numel() * t.element_size() for t in ops)
    out_bytes = n_out * q.numel() * q.element_size()
    flops = products * 4 * B * H * L * S * D          # QKᵀ and PV, 2 flops per MAC
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    ms, plain_ms, library_ms = time_ms(torch, kernel), time_ms(torch, plain), time_ms(torch, library)
    print(f"  {name} bf16 B={B} H={H} L={L} S={S} D={D}: kernel {ms * 1e3:.1f} us, plain "
          f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us, bound {max(t_bytes, t_ops) * 1e3:.1f} us "
          f"({(in_bytes + out_bytes) / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    return {"name": name, "route": "cuda", "source": "druglamp_tpu_torch/csrc/attention.cu",
            "replaces": ("druglamp_tpu/kernels/paired_attention_pallas.py:102" if paired
                         else "druglamp_tpu/kernels/paired_attention_pallas.py:191"),
            "launches": launches[name], "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def serve_timing(torch, predictor, pairs):
    """Phase 5b: pairs/s of predict_pairs (synchronised), a host/device split of
    one chunk, peak memory, and a profiler table of one forward."""
    predictor.predict_pairs(pairs)                   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        predictor.predict_pairs(pairs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    chunk = pairs[:32]
    t0 = time.perf_counter()
    host = predictor._featurize(chunk)
    feat_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: predictor.model(batch), iters=5, reps=5, warmup=2)
    print(f"  predict_pairs: {len(pairs) / wall:.1f} pairs/s ({wall * 1e3:.1f} ms for "
          f"{len(pairs)} pairs, median of 3), peak device memory {peak_gib:.2f} GiB", flush=True)
    print(f"  one chunk of 32: featurize (host) {feat_ms:.1f} ms, host->device {h2d_ms:.1f} ms, "
          f"forward (device, CUDA events) {fwd_ms:.2f} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predictor.model(batch)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    key = ("self_device_time_total" if averages and hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    table = averages.table(sort_by=key, row_limit=25)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "serve_profile.txt"), "w") as f:
        f.write(table)
    print("  profiler, one forward of 32 pairs (top 12 by self device time):", flush=True)
    for line in table.splitlines()[:15]:
        print("    " + line)


TRAIN_B = 16                 # the recipe's batch
TRAIN_STEPS = 10
TRAIN_LR = 1e-4


def backward_checks(torch, attention):
    """Phase 3, backwards: gradients through the autograd Functions (forward
    and backward kernels) against the plain backward; fails outside
    tolerance.  Returns max |err| per kernel at the bf16 training shapes."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [(TRAIN_B, 4, 256, 256, 64, True), (TRAIN_B, 4, 256, 256, 128, False),
             (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False)]
    train_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, L, S, D, paired in cases:
            ins = make_operands(torch, g, B, H, L, S, D, dtype, paired)
            # incoming gradients as _merge_heads's backward gives them: (B, L, H, D) transposed
            dos = [torch.randn(B, L, H, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
                   for _ in range(2 if paired else 1)]
            leaves = [t.clone().requires_grad_() for t in ins]
            outs = (attention.paired_attention(*leaves) if paired
                    else (attention.self_attention(*leaves),))
            got = torch.autograd.grad(outs, leaves, dos)
            plain = (attention.paired_attention_bwd_plain if paired
                     else attention.self_attention_bwd_plain)
            if dtype == torch.float32:
                ref = plain(*ins, *dos)
                ok = all(torch.allclose(a, b, atol=2e-5, rtol=2e-5) for a, b in zip(got, ref))
                errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
                tols = [2e-5 + 2e-5 * b.abs().max().item() for b in ref]
            else:
                ref = plain(*(t.float() for t in ins), *(t.float() for t in dos))
                errs = [(a.float() - b).abs().max().item() for a, b in zip(got, ref)]
                tols = [bf16_ulp(b.abs().max().item()) for b in ref]
                ok = all(e <= t for e, t in zip(errs, tols))
            torch.cuda.synchronize()
            name = "paired_attention_bwd" if paired else "self_attention_bwd"
            grads = "dq dk dv dq_o".split()[:len(got)]
            print(f"  {name} {str(dtype).split('.')[-1]} B={B} H={H} L={L} S={S} D={D}: "
                  + ", ".join(f"{n} {e:.3e} (tol {t:.3e})" for n, e, t in zip(grads, errs, tols)),
                  flush=True)
            if not ok:
                fail(f"{name} disagrees with its plain version at {(B, H, L, S, D)} {dtype}")
            if dtype == torch.bfloat16 and B == TRAIN_B:
                train_err[name] = max(errs)
    return train_err


def make_trainer(torch, cfg):
    """(model, state, step, batch on the card) for DrugLAMP at ``cfg``, weights
    drawn from SEED, one compact batch of TRAIN_B from the port's make_batch."""
    from druglamp_tpu_torch.data.encoding import compact_batch
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_train_step
    from druglamp_tpu_torch.utils.synthetic import make_batch

    model = build_model("DrugLAMP", cfg, generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    host = make_batch(cfg, TRAIN_B, seed=SEED, n_drug_feature=384, n_prot_feature=640)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in compact_batch(host, (host["d_fill"] == 0).sum(1)).items()}
    return model, TrainState.create(model), make_train_step(model, False, False), batch


def f32_step_agreement(torch, attention, cfg):
    """The f32 step with dropout 0 through the kernels and through the plain
    attention, from the same weights: step-1 gradients within rtol 5e-3 /
    atol 5e-5 (docs/PARITY.md's gradient tolerance) and the losses of 3 steps
    within 1e-5."""
    import dataclasses

    cfg32 = dataclasses.replace(cfg, pmma_dropout=0.0, solver=dataclasses.replace(
        cfg.solver, compute_dtype="float32"))
    runs = []
    for plain in (False, True):
        model, state, step, batch = make_trainer(torch, cfg32)
        ctx = plain_attention(attention) if plain else contextlib.nullcontext()
        attention.reset_launch_counts()
        losses, grads = [], None
        with ctx:
            for i in range(3):
                losses.append(float(step(state, batch, None, TRAIN_LR).cls_loss))
                if i == 0:
                    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        bwd = attention.LAUNCHES["paired_attention_bwd"] + attention.LAUNCHES["self_attention_bwd"]
        if (bwd == 0) != plain:
            fail(f"f32 step ({'plain' if plain else 'kernels'}): backward launches {bwd}")
        runs.append((losses, grads))
        del model, state, step, batch
    (l_k, g_k), (l_p, g_p) = runs
    bad = [n for n in g_k if not torch.allclose(g_k[n], g_p[n], rtol=5e-3, atol=5e-5)]
    worst = max((g_k[n] - g_p[n]).abs().max().item() for n in g_k)
    dloss = max(abs(a - b) for a, b in zip(l_k, l_p))
    print(f"  f32, dropout 0, kernels vs plain attention: step-1 gradients of {len(g_k)} "
          f"parameters, max |Δg| {worst:.3e} (rtol 5e-3, atol 5e-5), {len(bad)} outside; "
          f"losses {['%.7f' % x for x in l_k]} vs {['%.7f' % x for x in l_p]}, "
          f"max |Δ| {dloss:.3e} (tol 1e-5)", flush=True)
    if bad or dloss > 1e-5:
        fail(f"f32 step disagrees with its plain-attention run: {bad[:5]}, |Δloss| {dloss:.3e}")


def train_checks(torch, attention):
    """Phase 6: returns (model, state, step, batch, launch counts of the main
    path)."""
    from druglamp_tpu_torch.config import Config

    cfg = Config()
    model, state, step, batch = make_trainer(torch, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  DrugLAMP at Config(), {cfg.solver.compute_dtype}, {n_params} parameters; "
          f"compact batch of {TRAIN_B} decoded on the card; {TRAIN_STEPS} steps at lr "
          f"{TRAIN_LR}, pmma dropout {cfg.pmma_dropout}", flush=True)

    attention.reset_launch_counts()
    losses = [step(state, batch, gen, TRAIN_LR).cls_loss for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = dict(attention.LAUNCHES)
    per_step = {"paired_attention_fwd": 4, "self_attention_fwd": 2,
                "paired_attention_bwd": 4, "self_attention_bwd": 2}
    print(f"  main path: {TRAIN_STEPS} steps, launches {launches}", flush=True)
    if launches != {k: TRAIN_STEPS * v for k, v in per_step.items()}:
        fail(f"kernel launches {launches}, expected {per_step} per step")
    losses = [float(x) for x in losses]
    print(f"  cls losses: {['%.6f' % x for x in losses]}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite cls loss")
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
    if missing:
        fail(f"parameters without a finite gradient: {missing[:5]}")
    qkv = [n for n, _ in model.named_parameters() if n.startswith("pmma.")
           and n.split(".")[-2] in ("query", "key", "value", "query_mol", "key_mol", "value_mol")
           and n.endswith(".weight")]
    zero = [n for n in qkv if model.get_parameter(n).grad.abs().max().item() == 0]
    print(f"  gradients: all {n_params} entries finite; {len(qkv)} PMMA q/k/v weights, "
          f"{len(zero)} with a zero gradient", flush=True)
    if len(qkv) != 18 or zero:
        fail(f"PMMA q/k/v weights without gradient: {zero} (of {len(qkv)})")

    f32_step_agreement(torch, attention, cfg)
    return model, state, step, batch, launches


def bwd_kernel_record(torch, F, attention, name, paired, launches, max_abs_err):
    """One backward kernel at the training shapes in bf16: kernel, plain, and
    the SDPA backward yardstick timed in turns; bound from this run's bytes."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    B, H, L, S = TRAIN_B, 4, 256, 256
    D = 64 if paired else 128
    ins = make_operands(torch, g, B, H, L, S, D, torch.bfloat16, paired)
    q, k, v = ins[:3]
    q_o = ins[3] if paired else None
    dos = [torch.randn(B, H, L, D, generator=g, device="cuda").to(torch.bfloat16)
           for _ in range(2 if paired else 1)]
    _, lse = attention.launch_forward(q, k, v, q_o, with_lse=True)
    kernel = lambda: attention.launch_backward(q, k, v, q_o, lse, dos)      # noqa: E731
    if paired:
        plain = lambda: attention.paired_attention_bwd_plain(*ins, *dos)   # noqa: E731
    else:
        plain = lambda: attention.self_attention_bwd_plain(*ins, *dos)     # noqa: E731
    leaves = [t.clone().requires_grad_() for t in ins]
    if paired:
        outs = (F.scaled_dot_product_attention(leaves[0], leaves[1], leaves[2]),
                F.scaled_dot_product_attention(leaves[3], leaves[1], leaves[2]))
    else:
        outs = (F.scaled_dot_product_attention(*leaves),)
    library = lambda: torch.autograd.grad(outs, leaves, dos, retain_graph=True)  # noqa: E731

    n_out = len(ins)                                  # one gradient per input
    elem = q.element_size()
    in_bytes = sum(t.numel() for t in list(ins) + dos) * elem
    out_bytes = sum(t.numel() for t in ins) * elem
    products = 2 if paired else 1
    flops = products * 10 * B * H * L * S * D     # S, dV, dP, dQ, dK: 2 flops per MAC each
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    turns = [("kernel", kernel), ("library", library), ("library", library), ("kernel", kernel)]
    times = {"kernel": [], "library": []}
    for label, fn in turns:
        times[label].append(time_ms(torch, fn))
    ms, library_ms = statistics.mean(times["kernel"]), statistics.mean(times["library"])
    plain_ms = time_ms(torch, plain)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        library()
        torch.cuda.synchronize()
    sdpa = sorted(device_kernels(torch, prof.key_averages()),
                  key=lambda e: -e.self_device_time_total)
    backend = "; ".join(e.key[:90] for e in sdpa[:3]) or "not shown by the profiler"
    print(f"  {name} bf16 B={B} H={H} L={L} S={S} D={D}: kernel {ms * 1e3:.1f} us "
          f"(turns {', '.join('%.1f' % (t * 1e3) for t in times['kernel'])}), plain "
          f"{plain_ms * 1e3:.1f} us, sdpa backward {library_ms * 1e3:.1f} us (turns "
          f"{', '.join('%.1f' % (t * 1e3) for t in times['library'])}), bound "
          f"{max(t_bytes, t_ops) * 1e3:.1f} us ({(in_bytes + out_bytes) / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP); {n_out} gradients; "
          f"{launches[name] // TRAIN_STEPS} launches per step", flush=True)
    print(f"  sdpa backward kernels ({name} yardstick): {backend}", flush=True)
    return {"name": name, "route": "cuda", "source": "druglamp_tpu_torch/csrc/attention_bwd.cu",
            "replaces": ("druglamp_tpu/kernels/paired_attention_pallas.py:136" if paired
                         else "druglamp_tpu/kernels/paired_attention_pallas.py:216"),
            "launches": launches[name], "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def device_kernels(torch, averages):
    """The profiler rows of kernels run on the card: device-side rows that
    are not annotation ranges (an optimizer step or an autograd Function
    also shows as a device-side range over its kernels)."""
    cpu_keys = {e.key for e in averages if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in cpu_keys and not getattr(e, "is_user_annotation", False)]


def train_timing(torch, attention, model, state, step, batch):
    """Phase 7: step time, pairs/s, peak memory, device-busy share, and a
    profiler table of one step."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    run = lambda: step(state, batch, gen, TRAIN_LR)                  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, run, iters=TRAIN_STEPS, reps=5, warmup=3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  train step (bf16, batch {TRAIN_B}, CUDA events, median of 5 x {TRAIN_STEPS} "
          f"steps): {step_ms:.2f} ms, {TRAIN_B / step_ms * 1e3:.1f} pairs/s, peak device "
          f"memory {peak_gib:.2f} GiB", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        run()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    torch.cuda.synchronize()
    print(f"  host time to issue a step (no synchronisation, mean of {TRAIN_STEPS}): "
          f"{enqueue_ms:.2f} ms", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernels = device_kernels(torch, averages)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_ops = sum(e.count for e in averages
                if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::"))
    print(f"  one step issues {n_ops} aten op calls (nested calls included) and "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    table = averages.table(sort_by="self_device_time_total", row_limit=40)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train_profile.txt"), "w") as f:
        f.write(table + "\n\nThe same step by self CPU time (host work):\n")
        f.write(averages.table(sort_by="self_cpu_time_total", row_limit=40))
    if busy_ms > 0:
        print(f"  device busy in a step: {busy_ms:.2f} ms of kernel time over the {step_ms:.2f} ms "
              f"step = {busy_ms / step_ms:.1%}", flush=True)
    else:
        print("  device busy in a step: not measured (the profiler shows no device time)",
              flush=True)
    ours = {n: sum(e.self_device_time_total for e in kernels if n in e.key) / 1e3
            for n in ("attention_fwd_kernel", "attention_dq_kernel", "attention_dkv_kernel")}
    print("  attention kernels in the step (ms of device time): "
          + ", ".join(f"{n} {t:.3f}" for n, t in ours.items()), flush=True)
    print("  profiler, one train step (top 20 by self device time):", flush=True)
    for line in table.splitlines()[:23]:
        print("    " + line)


def main() -> None:
    if not os.path.isdir(os.path.join(REPO, "druglamp_tpu_torch")):
        fail("druglamp_tpu_torch/ not found next to chip_smoke.py: run from a checkout")
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F

    phase("1 device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=TIMEOUT_S, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi failed: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, count {count}")
    print(f"  nvidia-smi: {smi}")
    print("  TF32 off for matmuls and cuDNN (f32 phases compare true f32)", flush=True)

    phase("2 build")
    from druglamp_tpu_torch.kernels import attention, build

    t0 = time.perf_counter()
    logs = build.build()
    print(f"  built {sorted(logs) or 'nothing (libraries present)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    phase("3 kernels vs plain")
    serve_err = kernel_checks(torch, attention)
    train_err = backward_checks(torch, attention)

    phase("4 serving path")
    predictor, pairs, launches = serve_checks(torch, attention)

    phase("5 timing")
    print(f"  card: {smi}", flush=True)
    records = [kernel_record(torch, F, attention, "paired_attention_fwd", True, launches,
                             serve_err["paired_attention_fwd"]),
               kernel_record(torch, F, attention, "self_attention_fwd", False, launches,
                             serve_err["self_attention_fwd"])]
    serve_timing(torch, predictor, pairs)
    del predictor

    phase("6 training step")
    model, state, step, batch, train_launches = train_checks(torch, attention)

    phase("7 training timing")
    print(f"  card: {smi}", flush=True)
    train_timing(torch, attention, model, state, step, batch)
    records += [bwd_kernel_record(torch, F, attention, "paired_attention_bwd", True,
                                  train_launches, train_err["paired_attention_bwd"]),
                bwd_kernel_record(torch, F, attention, "self_attention_bwd", False,
                                  train_launches, train_err["self_attention_bwd"])]

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
