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
   ptxas report (registers, shared memory, spills); fails if a tensor-core
   kernel spills.  Prints the bf16 backward kernels' dynamic shared memory
   and resident blocks per SM on this card.
3. kernels — holds each kernel against its plain PyTorch version on the same
   inputs: the forwards at the serving shapes (B=32, H=4, L=S=256; D=64
   paired, D=128 self), the training shapes (B=16) and ragged small shapes,
   in f32 (the FMA kernel; atol = rtol = 1e-5) and bf16 (the tensor-core
   kernel; |err| ≤ one bf16 ulp at the output's largest magnitude: the
   kernel keeps ~16 bits of the probabilities, P_hi + P_lo, where the plain
   version rounds them to bf16), each with its log-sum-exp within 1e-5 of
   the plain one; the backwards, through the autograd Functions with incoming
   gradients made non-contiguous as ``_merge_heads`` makes them, at the
   training shapes (B=16), the same ragged shapes and one with L > S, in f32
   (the FMA kernels; atol = rtol = 2e-5) and bf16 (the tensor-core kernels;
   one bf16 ulp at each gradient's largest magnitude of the plain backward
   run in f32 on the same bf16 inputs); two bf16 backward calls at the
   training shapes give bit-identical gradients.
4. serve   — ``Predictor`` at the default full-width ``Config()`` (bf16),
   with seeded weights and BatchNorm running stats taken from the first
   chunk, scores 64 pairs (two chunks of 32) through the kernels; asserts 4
   paired and 2 self launches per chunk, probabilities finite in [0, 1],
   and agreement with the same
   Predictor run through the plain attention on the card (bf16, and again
   at f32); runs ``return_attn=True`` once.
5. timing  — each forward kernel and its yardstick
   ``F.scaled_dot_product_attention`` (two calls for paired; timed here, never
   called by the port) in bf16 at the serving (B=32) and training (B=16)
   shapes, by the profiler's device time per call in turns kernel, sdpa,
   sdpa, kernel, beside the least time the card could take, the plain
   version's time and the CUDA-event time of back-to-back calls; Predictor
   pairs/s and peak device memory; the device time of one forward and of
   its attention kernels, and a profiler table of the forward by kernel
   (written to ``chiprun_out/serve_profile.txt`` as well).
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
   yardstick ``F.scaled_dot_product_attention``'s backward, by device time in
   turns kernel, sdpa, sdpa, kernel, with the CUDA-event time of back-to-back
   calls beside them (its kernels' names show the backend SDPA picked).
8. packed GCN — ``gcn_packed_matmul`` (``csrc/gcn_packed.cu``) against its
   plain version, forward and backward through its autograd Function, at
   the training (16, 512, 128), eval (64, 512, 128) and a small ragged
   (3, 256, 64) shape: f32 atol = rtol = 1e-5; bf16 y within 1e-5 of its
   largest |y| and dx within one bf16 ulp.
9. epoch   — the device-resident dataset: a CSV dataset of 37 real drugs,
   64 proteins of 50–1022 residues, 512 training and 128 validation pairs
   (all from SEED), an ``EmbeddingCache`` of seeded embeddings at the real
   token lengths, ``DeviceEmbeddingStore`` and ``DeviceDataStore`` on the
   card.  DrugLAMP at ``Config()`` (bf16, seeded weights) with
   ``DRUGLAMP_PACKED_GCN=1``: one epoch of ``make_epoch_step_gather`` (32
   steps at batch 16 in one call), asserting 3 + 3 GCN and 4/2/4/2
   attention launches per step, finite losses and non-zero gradients on
   every GCN weight; ``make_eval_scan_gather`` on the validation split at
   batch 64 (3 GCN and 4/2 attention launches per batch, AUROC and AUPRC).
   The first 3 steps at f32, dropout 0: through the kernel, within 1e-5 of
   the plain GCN and within rtol 2e-4 of the dense adjacency.  Then the
   epoch's pairs/s (CUDA events), host time to issue it, peak memory, and
   from one profiled epoch the device-busy share, the host → device bytes
   and the count of host reads of device values (must be 0; tables in
   ``chiprun_out/epoch_profile.txt``); the kernel beside its bound, its
   plain version and the dense ``torch.bmm`` yardstick on real batches.

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
# More real drugs for the training epoch's dataset (phase 9).
EPOCH_SMILES = SMILES + [
    "CC(C)NCC(O)COC1=CC=CC2=CC=CC=C21",                          # propranolol
    "CN1CCC[C@H]1C2=CN=CC=C2",                                   # nicotine
    "OC(=O)CC1=CC=CC=C1NC1=C(Cl)C=CC=C1Cl",                      # diclofenac
    "CN1CCN(CC1)C2=NC3=CC=CC=C3NC4=C2C=C(C=C4)Cl",               # clozapine
    "NC(=O)C1=CC=CN=C1",                                         # nicotinamide
    "CC(C)(C)NCC(O)C1=CC(=C(C=C1)O)CO",                          # salbutamol
    "CN1C(=O)CN=C(C2=C1C=CC(=C2)Cl)C3=CC=CC=C3",                 # diazepam
    "CCN(CC)CC(=O)NC1=C(C)C=CC=C1C",                             # lidocaine
    "OC(=O)C1=CC=CC=C1O",                                        # salicylic acid
    "CC12CCC3C(C1CCC2O)CCC4=C3C=CC(=C4)O",                       # estradiol
    "CN1CCC23C4C1CC5=C2C(=C(C=C5)O)OC3C(C=C4)O",                 # morphine
    "CC(C)CC(CC(=O)O)CN",                                        # pregabalin
    "C1CCC(CC1)(CC(=O)O)CN",                                     # gabapentin
    "CC(CS)C(=O)N1CCCC1C(=O)O",                                  # captopril
    "CCOC(=O)C1=C(NC(=C(C1C2=CC=CC=C2Cl)C(=O)OC)C)COCCN",        # amlodipine
    "CN(C)CCCN1C2=CC=CC=C2CCC3=CC=CC=C31",                       # imipramine
    "CC(C)C1=C(C(=C(N1CCC(CC(CC(=O)O)O)O)C2=CC=C(C=C2)F)C3=CC=CC=C3)C(=O)NC4=CC=CC=C4",  # atorvastatin
    "CS(=O)(=O)NC1=C(C=C(C=C1)[N+](=O)[O-])OC2=CC=CC=C2",        # nimesulide
    "C1=CC=C2C(=C1)C(=CN2)CCN",                                  # tryptamine
    "CC(C)NCC(COC1=CC=C(C=C1)CC(N)=O)O",                         # atenolol
    "COC1=CC2=C(C=C1)N=C(N2)S(=O)CC3=NC=C(C(=C3C)OC)C",          # omeprazole
    "CC(C)(C)C1=CC=C(C=C1)C(O)CCCN2CCC(CC2)C(O)(C3=CC=CC=C3)C4=CC=CC=C4",  # terfenadine
    "CC(=O)NC1=NN=C(S1)S(N)(=O)=O",                              # acetazolamide
    "CN1C2CCC1CC(C2)OC(=O)C(CO)C3=CC=CC=C3",                     # atropine
    "O=C1NC(=O)C(N1)(c1ccccc1)c1ccccc1",                         # phenytoin
    "CN1C=NC(=C1SC2=NC=NC3=C2NC=N3)[N+](=O)[O-]",                # azathioprine
    "CC(=O)CC(C1=CC=CC=C1)C2=C(C3=CC=CC=C3OC2=O)O",              # warfarin
    "CNCCC(C1=CC=CC=C1)OC2=CC=C(C=C2)C(F)(F)F",                  # fluoxetine
    "CC1=NN=C2N1C3=C(C=C(C=C3)Cl)C(=NC2)C4=CC=CC=C4",            # alprazolam
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


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes per kernel from nvcc's ``-Xptxas -v`` output."""
    import re

    report, func = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            func = m.group(1)
            report.setdefault(func, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and func:
            report[func].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            report[func]["registers"] = int(m.group(1))
    return report


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
    cases = [  # (B, H, L, S, D, paired): serving, training, then ragged shapes that
        # cover the other instantiations
        (32, 4, 256, 256, 64, True), (32, 4, 256, 256, 128, False),
        (TRAIN_B, 4, 256, 256, 64, True), (TRAIN_B, 4, 256, 256, 128, False),
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
            # the log-sum-exp the backward kernels read, against the plain one
            _, lse = attention.launch_forward(*ops[:3], ops[3] if paired else None, with_lse=True)
            torch.cuda.synchronize()
            lse_err = (lse - plain_lse(torch, ops)).abs().max().item()
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
                  f"max_abs_err {err:.3e} (tol {tol:.3e}, max |out| {peak:.3f}); lse "
                  f"{lse_err:.3e} (tol 1e-5)", flush=True)
            if not ok or lse_err > 1e-5:
                fail(f"{name} disagrees with its plain version at {(B, H, L, S, D)} {dtype}")
            if dtype == torch.bfloat16 and (B, L, S) == (32, 256, 256):
                serve_err[name] = err
    return serve_err


def plain_lse(torch, ops):
    """(NQ, B·H, L) log-sum-exp of each query set's f32 logits scaled by 1/√D."""
    k = ops[1].float()
    qs = (ops[0], ops[3]) if len(ops) == 4 else (ops[0],)
    B, H, L, D = ops[0].shape
    return torch.stack([torch.logsumexp(torch.matmul(q.float(), k.transpose(-1, -2))
                                        / math.sqrt(D), -1).reshape(B * H, L) for q in qs])


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


def make_proteins(rng, n: int):
    """n sequences of 50–1022 residues (the first the longest the model keeps)."""
    lengths = rng.randint(50, 1023, size=n)
    lengths[0] = 1022
    return ["".join(rng.choice(list(AMINO), size=int(m))) for m in lengths]


def make_pairs(n: int):
    import numpy as np

    seqs = make_proteins(np.random.RandomState(SEED), n)
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


def fwd_timing(torch, F, attention, paired, B, with_plain):
    """One forward kernel in bf16 at batch B (H=4, L=S=256; D=64 paired, 128
    self): the kernel and its yardstick F.scaled_dot_product_attention (two
    calls for paired) timed in turns kernel, sdpa, sdpa, kernel by their
    device time (``device_ms``: a call takes less device time than the host
    needs to issue it), with the CUDA-event time per call of back-to-back
    calls beside them; the plain version when asked; the bound from this
    call's bytes and operations.  Prints one line and returns (ms,
    library_ms, plain_ms or None, bound_ms, bound_by)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    H, L, S = 4, 256, 256
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
    times = {"kernel": [], "library": []}
    for label, fn in (("kernel", kernel), ("library", library), ("library", library),
                      ("kernel", kernel)):
        times[label].append(device_ms(torch, fn))
    ms, library_ms = statistics.mean(times["kernel"]), statistics.mean(times["library"])
    plain_ms = device_ms(torch, plain) if with_plain else None
    issue = {"kernel": time_ms(torch, kernel), "library": time_ms(torch, library)}
    bound_ms = max(t_bytes, t_ops)
    name = "paired_attention_fwd" if paired else "self_attention_fwd"
    print(f"  {name} bf16 B={B} H={H} L={L} S={S} D={D}, device time per call: kernel "
          f"{ms * 1e3:.2f} us (turns {', '.join('%.2f' % (t * 1e3) for t in times['kernel'])}), "
          f"sdpa{' x2' if paired else ''} {library_ms * 1e3:.2f} us (turns "
          f"{', '.join('%.2f' % (t * 1e3) for t in times['library'])}), "
          + (f"plain {plain_ms * 1e3:.1f} us, " if with_plain else "")
          + f"bound {bound_ms * 1e3:.2f} us ({(in_bytes + out_bytes) / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP); kernel / bound {ms / bound_ms:.2f}, kernel / sdpa "
          f"{ms / library_ms:.2f}; back-to-back calls by CUDA events: kernel "
          f"{issue['kernel'] * 1e3:.1f} us, sdpa {issue['library'] * 1e3:.1f} us per call",
          flush=True)
    return ms, library_ms, plain_ms, bound_ms, "bytes" if t_bytes >= t_ops else "operations"


def kernel_record(torch, F, attention, name, paired, launches, max_abs_err):
    """The forward kernel's record: timed at the serving shape (B=32, with its
    plain version) and at the training shape (B=TRAIN_B)."""
    ms, library_ms, plain_ms, bound_ms, bound_by = fwd_timing(torch, F, attention, paired, 32,
                                                              True)
    train_ms, train_library_ms, _, train_bound_ms, _ = fwd_timing(torch, F, attention, paired,
                                                                  TRAIN_B, False)
    return {"name": name, "route": "cuda", "source": "druglamp_tpu_torch/csrc/attention.cu",
            "replaces": ("druglamp_tpu/kernels/paired_attention_pallas.py:102" if paired
                         else "druglamp_tpu/kernels/paired_attention_pallas.py:191"),
            "launches": launches[name], "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "train_ms": train_ms,
            "train_library_ms": train_library_ms, "train_bound_ms": train_bound_ms}


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
    kernels = device_kernels(torch, averages)
    fwd = [e for e in kernels if "attention_fwd" in e.key]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  one forward of 32 pairs, profiled: {busy_ms:.3f} ms of kernel time, of which the "
          f"attention forwards {sum(e.self_device_time_total for e in fwd) / 1e3:.3f} ms in "
          f"{sum(e.count for e in fwd)} launches", flush=True)
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
             (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False), (2, 3, 150, 70, 64, True)]
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


def determinism_checks(torch, attention):
    """Phase 3: two bf16 backward launches on the same inputs at the
    training shapes give bit-identical gradients (no atomics)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for paired in (True, False):
        D = 64 if paired else 128
        ops = make_operands(torch, g, TRAIN_B, 4, 256, 256, D, torch.bfloat16, paired)
        q_o = ops[3] if paired else None
        dos = [torch.randn(ops[0].shape, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(2 if paired else 1)]
        outs, lse = attention.launch_forward(*ops[:3], q_o, with_lse=True)
        runs = [attention.launch_backward(*ops[:3], q_o, outs, lse, dos) for _ in range(2)]
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(*runs)]
        name = "paired_attention_bwd" if paired else "self_attention_bwd"
        print(f"  {name} bf16 B={TRAIN_B} H=4 L=S=256 D={D}, two calls bit-identical: "
              f"{dict(zip('dq dk dv dq_o'.split(), same))}", flush=True)
        if not all(same):
            fail(f"{name}: two calls on the same inputs differ")


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
    """One backward kernel at the training shapes in bf16: the kernel and the
    SDPA backward yardstick timed in turns (kernel, sdpa, sdpa, kernel) by
    their device time (``device_ms``: at tens of µs a call takes less device
    time than the host needs to issue it), with the CUDA-event time per call
    of back-to-back calls beside them; the plain version's device time; the
    bound from this run's bytes and operations; SDPA's backend from its
    kernels' names.  The record carries the forward records' keys; the
    backward runs only at the training shape, so its ``train_*`` values are
    the same numbers."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    B, H, L, S = TRAIN_B, 4, 256, 256
    D = 64 if paired else 128
    ins = make_operands(torch, g, B, H, L, S, D, torch.bfloat16, paired)
    q, k, v = ins[:3]
    q_o = ins[3] if paired else None
    dos = [torch.randn(B, H, L, D, generator=g, device="cuda").to(torch.bfloat16)
           for _ in range(2 if paired else 1)]
    outs, lse = attention.launch_forward(q, k, v, q_o, with_lse=True)
    kernel = lambda: attention.launch_backward(q, k, v, q_o, outs, lse, dos)  # noqa: E731
    if paired:
        plain = lambda: attention.paired_attention_bwd_plain(*ins, *dos)   # noqa: E731
    else:
        plain = lambda: attention.self_attention_bwd_plain(*ins, *dos)     # noqa: E731
    leaves = [t.clone().requires_grad_() for t in ins]
    if paired:
        sdpa_outs = (F.scaled_dot_product_attention(leaves[0], leaves[1], leaves[2]),
                     F.scaled_dot_product_attention(leaves[3], leaves[1], leaves[2]))
    else:
        sdpa_outs = (F.scaled_dot_product_attention(*leaves),)
    library = lambda: torch.autograd.grad(sdpa_outs, leaves, dos, retain_graph=True)  # noqa: E731

    n_out = len(ins)                                  # one gradient per input
    elem = q.element_size()
    in_bytes = sum(t.numel() for t in list(ins) + dos) * elem
    out_bytes = sum(t.numel() for t in ins) * elem
    products = 2 if paired else 1
    flops = products * 10 * B * H * L * S * D     # S, dV, dP, dQ, dK: 2 flops per MAC each
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    bound_ms = max(t_bytes, t_ops)
    times = {"kernel": [], "library": []}
    for label, fn in (("kernel", kernel), ("library", library), ("library", library),
                      ("kernel", kernel)):
        times[label].append(device_ms(torch, fn))
    ms, library_ms = statistics.mean(times["kernel"]), statistics.mean(times["library"])
    plain_ms = device_ms(torch, plain)
    issue = {"kernel": time_ms(torch, kernel), "library": time_ms(torch, library)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        library()
        torch.cuda.synchronize()
    sdpa = sorted(device_kernels(torch, prof.key_averages()),
                  key=lambda e: -e.self_device_time_total)
    backend = "; ".join(e.key[:90] for e in sdpa[:3]) or "not shown by the profiler"
    print(f"  {name} bf16 B={B} H={H} L={L} S={S} D={D}, device time per call: kernel "
          f"{ms * 1e3:.2f} us (turns {', '.join('%.2f' % (t * 1e3) for t in times['kernel'])}), "
          f"sdpa backward {library_ms * 1e3:.2f} us (turns "
          f"{', '.join('%.2f' % (t * 1e3) for t in times['library'])}), plain "
          f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
          f"({(in_bytes + out_bytes) / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); kernel / bound "
          f"{ms / bound_ms:.2f}, kernel / sdpa {ms / library_ms:.2f}; back-to-back calls by CUDA "
          f"events: kernel {issue['kernel'] * 1e3:.1f} us, sdpa {issue['library'] * 1e3:.1f} us "
          f"per call; {n_out} gradients; {launches[name] // TRAIN_STEPS} launches per step",
          flush=True)
    print(f"  sdpa backward kernels ({name} yardstick): {backend}", flush=True)
    return {"name": name, "route": "cuda", "source": "druglamp_tpu_torch/csrc/attention_bwd.cu",
            "replaces": ("druglamp_tpu/kernels/paired_attention_pallas.py:136" if paired
                         else "druglamp_tpu/kernels/paired_attention_pallas.py:216"),
            "launches": launches[name], "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "train_ms": ms, "train_library_ms": library_ms,
            "train_bound_ms": bound_ms}


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
            for n in ("attention_fwd", "attention_dq", "attention_dkv")}
    print("  attention kernels in the step (ms of device time): "
          + ", ".join(f"{n} {t:.3f}" for n, t in ours.items()), flush=True)
    print("  profiler, one train step (top 20 by self device time):", flush=True)
    for line in table.splitlines()[:23]:
        print("    " + line)


GCN_CASES = [(TRAIN_B, 512, 128), (64, 512, 128), (3, 256, 64)]   # train, eval, ragged small


def packed_graphs(np, B: int, N: int, rng):
    """Random molecule-like graphs in the group-64 bits: ragged n_atoms,
    about four bonds per real atom, the universal self-loop; → (packed, real)."""
    from druglamp_tpu_torch.data.encoding import pack_adjacency

    n_atoms = rng.randint(N // 8, N // 2, size=B)
    adj = np.zeros((B, N, N), np.uint8)
    ar = np.arange(N)
    for b in range(B):
        i, j = rng.randint(0, n_atoms[b], size=(2, 2 * n_atoms[b]))
        adj[b, i, j] = adj[b, j, i] = 1
        adj[b, ar, ar] = 1
    return pack_adjacency(adj), (ar[None, :] < n_atoms[:, None]).astype(np.float32)


def gcn_checks(torch, gcn):
    """Phase 8: the packed GCN kernel against its plain version, forward and
    backward through the autograd Function (the backward is a second launch
    on dy cast to x's dtype; its plain version is the plain aggregate of that
    cast dy, S being symmetric).  f32: atol = rtol = 1e-5.  bf16 x: the
    products with A are exact and only the order of the f32 sums differs, so
    y within 1e-5 of its largest |y|; dx is rounded to bf16 once, so within
    one bf16 ulp of its largest magnitude.  Returns the bf16 forward max
    |err| at the training shape."""
    import numpy as np

    rng = np.random.RandomState(SEED + 4)
    train_err = None
    for B, N, C in GCN_CASES:
        packed, real = (torch.from_numpy(a).to(DEVICE) for a in packed_graphs(np, B, N, rng))
        nrm = torch.rsqrt(torch.clamp(gcn.packed_degrees(packed, real), min=1.0))
        n2r = nrm * nrm * real
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.randn(B, N, C).astype(np.float32)).to(DEVICE).to(dtype)
            dy = torch.from_numpy(rng.randn(B, N, C).astype(np.float32)).to(DEVICE)
            leaf = x.clone().requires_grad_()
            y = gcn.gcn_packed_matmul(packed, nrm, n2r, leaf)
            (dx,) = torch.autograd.grad(y, leaf, dy)
            ref = gcn.gcn_packed_plain(packed, nrm, n2r, x)
            ref_dx = gcn.gcn_packed_plain(packed, nrm, n2r, dy.to(dtype))
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            err_dx = (dx.float() - ref_dx).abs().max().item()
            peak, peak_dx = ref.abs().max().item(), ref_dx.abs().max().item()
            if dtype == torch.float32:
                tol, tol_dx = 1e-5 + 1e-5 * peak, 1e-5 + 1e-5 * peak_dx
                ok = torch.allclose(y, ref, atol=1e-5, rtol=1e-5) \
                    and torch.allclose(dx, ref_dx, atol=1e-5, rtol=1e-5)
            else:
                tol, tol_dx = 1e-5 * peak, bf16_ulp(peak_dx)
                ok = err <= tol and err_dx <= tol_dx
            print(f"  gcn_packed_matmul {str(dtype).split('.')[-1]} B={B} N={N} C={C}: "
                  f"y {err:.3e} (tol {tol:.3e}), dx {err_dx:.3e} (tol {tol_dx:.3e})", flush=True)
            if not ok:
                fail(f"gcn_packed_matmul disagrees with its plain version at {(B, N, C)} {dtype}")
            if dtype == torch.bfloat16 and B == TRAIN_B:
                train_err = err
    return train_err


EPOCH_PAIRS, VAL_PAIRS, N_PROTEINS, EVAL_B = 512, 128, 64, 64
F32_LR = 1e-5


def write_dataset(root: str):
    """A CSV dataset in the repo's layout (``<root>/synthetic/random/{train,
    val}.csv``): the real drugs of EPOCH_SMILES, N_PROTEINS proteins of
    50–1022 residues, EPOCH_PAIRS training and VAL_PAIRS validation pairs,
    all drawn from SEED."""
    import numpy as np

    rng = np.random.RandomState(SEED + 5)
    prots = make_proteins(rng, N_PROTEINS)
    split = os.path.join(root, "synthetic", "random")
    os.makedirs(split)
    for name, n in (("train.csv", EPOCH_PAIRS), ("val.csv", VAL_PAIRS)):
        d = rng.randint(0, len(EPOCH_SMILES), size=n)
        p = rng.randint(0, N_PROTEINS, size=n)
        y = rng.randint(0, 2, size=n)
        rows = [f"{EPOCH_SMILES[a]},{prots[b]},{c}" for a, b, c in zip(d, p, y)]
        with open(os.path.join(split, name), "w") as f:
            f.write("\n".join(["SMILES,Protein,Y"] + rows) + "\n")


def build_epoch_data(cfg, root: str):
    """Datasets, an embedding cache of seeded random embeddings at the real
    token lengths (drugs len(SMILES)+2 rows capped at max_nodes, proteins
    min(len, max_resis)+2), and both device stores on the card."""
    import numpy as np

    from druglamp_tpu_torch.data.cache import EmbeddingCache
    from druglamp_tpu_torch.data.dataset import DTIDataset
    from druglamp_tpu_torch.data.device_data import DeviceDataStore
    from druglamp_tpu_torch.data.device_store import DeviceEmbeddingStore

    write_dataset(root)
    kw = dict(max_nodes=cfg.drug.max_nodes, max_prot_resis=cfg.protein.max_resis,
              seq_len=cfg.protein.seq_len)
    train = DTIDataset(root, "synthetic", "random", "train.csv", **kw)
    val = DTIDataset(root, "synthetic", "random", "val.csv", table=train.table, **kw)
    table = train.table
    cache = EmbeddingCache(os.path.join(root, "embeddings"), "synthetic")
    rng = np.random.RandomState(SEED + 6)
    for smi, o in table.drug2ord.items():
        cache.put_drug(o, rng.randn(min(len(smi) + 2, cfg.drug.max_nodes), 384))
    for seq, o in table.prot2ord.items():
        cache.put_prot(o, rng.randn(min(len(seq), cfg.protein.max_resis) + 2, 640))
    emb = DeviceEmbeddingStore.build(table, cache, max_drug_tokens=cfg.drug.max_nodes,
                                     max_prot_len=cfg.protein.max_resis + 2, device=DEVICE)
    if emb is None:
        fail("DeviceEmbeddingStore over its budget")
    data = DeviceDataStore.build(table, cfg.drug.max_nodes, cfg.protein.seq_len, True, True,
                                 device=DEVICE)
    emb_bytes = sum(t.numel() * t.element_size() for t in emb.tree.values())
    print(f"  dataset: {table.n_drug} drugs, {table.n_prot} proteins, {len(train)} training "
          f"and {len(val)} validation pairs; DeviceDataStore {data.nbytes()} bytes, "
          f"DeviceEmbeddingStore {emb_bytes} bytes (drug_emb "
          f"{tuple(emb.tree['drug_emb'].shape)}, prot_emb {tuple(emb.tree['prot_emb'].shape)})",
          flush=True)
    return train, val, data, emb.tree


@contextlib.contextmanager
def plain_gcn(gcn):
    """Route the GCN aggregate through its plain version (autograd
    differentiates it); comparison only."""
    saved = gcn.gcn_packed_matmul
    gcn.gcn_packed_matmul = gcn.gcn_packed_plain
    try:
        yield
    finally:
        gcn.gcn_packed_matmul = saved


def reset_counts(attention, gcn) -> None:
    attention.reset_launch_counts()
    gcn.reset_launch_counts()


def epoch_checks(torch, attention, gcn, cfg, train, val, data, emb):
    """Phase 9: one epoch of make_epoch_step_gather (bf16, packed GCN on)
    and the eval pass of make_eval_scan_gather, the main path; then the f32
    agreement of the packed kernel with the plain and the dense GCN.
    Returns (state, epoch fn, plan, launch counts of the main path)."""
    import numpy as np

    from druglamp_tpu_torch.data.device_data import eval_index_plan, train_index_plan
    from druglamp_tpu_torch.eval.metrics import MetricCollector
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_epoch_step_gather, make_eval_scan_gather

    os.environ["DRUGLAMP_PACKED_GCN"] = "1"
    model = build_model("DrugLAMP", cfg, generator=torch.Generator().manual_seed(SEED))
    state = TrainState.create(model)
    epoch = make_epoch_step_gather(model, False, False, True, True, device=DEVICE)
    evaluate = make_eval_scan_gather(model, True, True, device=DEVICE)
    tree, vtree = data.tree_for(train), data.tree_for(val)
    idx = train_index_plan(np.random.RandomState(SEED).permutation(len(train)), TRAIN_B)
    ones = np.ones(idx.shape, np.float32)
    eidx, evalid = eval_index_plan(len(val), EVAL_B)
    S, SE = idx.shape[0], eidx.shape[0]
    print(f"  DrugLAMP at Config(), {cfg.solver.compute_dtype}, DRUGLAMP_PACKED_GCN=1; one epoch "
          f"of {S} steps at batch {TRAIN_B} (permutation from seed {SEED}) in one call, then the "
          f"validation pass of {SE} batches of {EVAL_B}", flush=True)

    reset_counts(attention, gcn)
    out = epoch(state, idx, ones, tree, emb, torch.Generator(device=DEVICE).manual_seed(SEED),
                TRAIN_LR)
    torch.cuda.synchronize()
    launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
    per_step = {"paired_attention_fwd": 4, "self_attention_fwd": 2, "paired_attention_bwd": 4,
                "self_attention_bwd": 2, "gcn_packed_matmul": 3, "gcn_packed_matmul_bwd": 3}
    print(f"  main path, epoch: launches {launches}", flush=True)
    if launches != {k: S * v for k, v in per_step.items()}:
        fail(f"epoch launches {launches}, expected {per_step} per step")
    losses = out.cls_losses.float().cpu().numpy()
    print(f"  cls losses: first {losses[:3].round(5).tolist()}, last {losses[-3:].round(5).tolist()}",
          flush=True)
    if out.cls_losses.shape != (S,) or not np.all(np.isfinite(losses)):
        fail(f"epoch losses not finite of shape ({S},)")
    names = [n for n, _ in model.named_parameters() if n.startswith("drug_extractor.")
             and n.endswith(".weight") and any(k in n for k in ("graph", "res_connection",
                                                                "init_transform"))]
    zero = [n for n in names if model.get_parameter(n).grad is None
            or model.get_parameter(n).grad.abs().max().item() == 0]
    print(f"  gradients: {len(names)} GCN graph/res_connection/init_transform weights, "
          f"{len(zero)} with a zero gradient", flush=True)
    if len(names) != 7 or zero:
        fail(f"GCN weights without gradient: {zero} (of {len(names)})")

    reset_counts(attention, gcn)
    probs, vlosses = evaluate(eidx, evalid, vtree, emb)
    torch.cuda.synchronize()
    eval_launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
    print(f"  main path, eval: launches {eval_launches}", flush=True)
    want = {k: (SE * v if k in ("paired_attention_fwd", "self_attention_fwd",
                                "gcn_packed_matmul") else 0) for k, v in per_step.items()}
    if eval_launches != want:
        fail(f"eval launches {eval_launches}, expected {want}")
    probs, vlosses = probs.float().cpu().numpy(), vlosses.float().cpu().numpy()
    if probs.shape != (SE, EVAL_B) or not (np.all(np.isfinite(probs))
                                           and np.all(np.isfinite(vlosses))):
        fail(f"eval probabilities {probs.shape} or losses not finite")
    mask = evalid.astype(bool)
    collector = MetricCollector()
    collector.update(probs[mask], val.labels[eidx[mask]])
    m = collector.compute()
    print(f"  validation: {int(mask.sum())} pairs, AUROC {m['auroc']:.4f}, AUPRC "
          f"{m['auprc']:.4f}, loss {vlosses.mean():.5f}; probabilities in "
          f"[{probs.min():.4f}, {probs.max():.4f}]", flush=True)
    launches = {k: launches[k] + eval_launches[k] for k in launches}

    epoch_f32_agreement(torch, gcn, cfg, tree, emb, idx[:3], ones[:3])
    os.environ["DRUGLAMP_PACKED_GCN"] = "1"
    return state, epoch, (idx, ones, tree), launches


def epoch_f32_agreement(torch, gcn, cfg, tree, emb, idx, ones):
    """The first 3 steps of the epoch at f32, dropout 0, from the same
    weights, three ways: the packed GCN through the kernel, through its
    plain version on the card, and dense (keep_packed off).  Kernel vs plain
    within 1e-5 (same products, f32 sums in another order); dense within
    rtol 2e-4 (tests/test_kernels.py's packed-vs-dense tolerance).  At lr
    1e-5, as tests/test_torch_port_device_data.py: Adam turns the sign of a
    near-zero step-1 gradient into a ±lr step, so the later losses of two
    f32 runs that differ in the last bits drift apart in proportion to lr
    (4.4e-5 in the second loss at lr 1e-4 on this data)."""
    import dataclasses

    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_epoch_step_gather

    cfg32 = dataclasses.replace(cfg, pmma_dropout=0.0, solver=dataclasses.replace(
        cfg.solver, compute_dtype="float32"))
    runs = {}
    for mode in ("kernel", "plain", "dense"):
        os.environ["DRUGLAMP_PACKED_GCN"] = "0" if mode == "dense" else "1"
        model = build_model("DrugLAMP", cfg32, generator=torch.Generator().manual_seed(SEED))
        epoch = make_epoch_step_gather(model, False, False, True, True, device=DEVICE)
        gcn.reset_launch_counts()
        with plain_gcn(gcn) if mode == "plain" else contextlib.nullcontext():
            out = epoch(TrainState.create(model), idx, ones, tree, emb,
                        torch.Generator(device=DEVICE).manual_seed(SEED), F32_LR)
        runs[mode] = [float(x) for x in out.cls_losses.cpu()]
        n = gcn.LAUNCHES["gcn_packed_matmul"] + gcn.LAUNCHES["gcn_packed_matmul_bwd"]
        if n != (6 * len(idx) if mode == "kernel" else 0):
            fail(f"f32 epoch ({mode}): {n} GCN kernel launches")
        del model, epoch, out
    d_plain = max(abs(a - b) for a, b in zip(runs["kernel"], runs["plain"]))
    r_dense = max(abs(a - b) / abs(b) for a, b in zip(runs["kernel"], runs["dense"]))
    print(f"  f32, dropout 0, 3 steps: kernel {['%.7f' % x for x in runs['kernel']]}, plain GCN "
          f"{['%.7f' % x for x in runs['plain']]} (max |Δ| {d_plain:.3e}, tol 1e-5), dense "
          f"{['%.7f' % x for x in runs['dense']]} (max rel {r_dense:.3e}, tol 2e-4)", flush=True)
    if d_plain > 1e-5 or r_dense > 2e-4:
        fail("the f32 packed epoch disagrees with the plain-GCN or the dense epoch")


def chrome_trace_h2d(prof):
    """(bytes, copies) host → device in a profiled window, from the memcpy
    events of its trace (the profiler's tables carry no byte counts)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    return sum(int(e.get("args", {}).get("bytes", 0)) for e in copies), len(copies)


def epoch_timing(torch, state, epoch, plan, emb):
    """Phase 9 timing: the epoch by CUDA events, the host time to issue it,
    peak memory; then one profiled epoch for the device-busy share, the
    host → device bytes and the count of host reads of device values."""
    from torch.profiler import ProfilerActivity, profile

    idx, ones, tree = plan
    n_pairs = idx.size
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    epoch(state, idx, ones, tree, emb, gen, TRAIN_LR)
    issue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    epoch_ms = start.elapsed_time(end)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  epoch ({idx.shape[0]} steps, {n_pairs} pairs, bf16, CUDA events): {epoch_ms:.1f} ms, "
          f"{n_pairs / epoch_ms * 1e3:.1f} pairs/s; host time to issue the call "
          f"{issue_s * 1e3:.1f} ms; peak device memory {peak_gib:.2f} GiB", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch(state, idx, ones, tree, emb, gen, TRAIN_LR)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernels = device_kernels(torch, averages)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    syncs = {k: sum(e.count for e in averages if e.key == k)
             for k in ("aten::item", "aten::_local_scalar_dense")}
    waits = {k: sum(e.count for e in averages if e.key == k)
             for k in ("cudaStreamSynchronize", "cudaDeviceSynchronize")}
    h2d_bytes, h2d_copies = chrome_trace_h2d(prof)
    ours = {n: sum(e.self_device_time_total for e in kernels if n in e.key) / 1e3
            for n in ("gcn_packed_kernel", "attention_fwd", "attention_dq", "attention_dkv")}
    table = averages.table(sort_by="self_device_time_total", row_limit=40)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "epoch_profile.txt"), "w") as f:
        f.write(table + "\n\nThe same epoch by self CPU time (host work):\n")
        f.write(averages.table(sort_by="self_cpu_time_total", row_limit=40))
    busy = (f"{busy_ms:.1f} ms of kernel time over the {epoch_ms:.1f} ms epoch = "
            f"{busy_ms / epoch_ms:.1%}" if busy_ms > 0
            else "not measured (the profiler shows no device time)")
    print(f"  profiled epoch: device busy {busy}; host->device {h2d_bytes} bytes in "
          f"{h2d_copies} copies; host reads of device values {syncs}; host waits {waits} "
          f"(the closing torch.cuda.synchronize included); {sum(e.count for e in kernels)} "
          f"kernel launches", flush=True)
    print("  our kernels in the epoch (ms of device time): "
          + ", ".join(f"{n} {t:.3f}" for n, t in ours.items()), flush=True)
    if any(syncs.values()):
        fail(f"the epoch reads device values back to the host: {syncs}")


def device_ms(torch, fn, iters: int = 50, warmup: int = 3) -> float:
    """Device time per call of ``fn``: the profiler's kernel time over
    ``iters`` back-to-back calls.  For calls whose kernels take less time
    than the host needs to issue them, CUDA events around a loop measure the
    host; the kernels' own device time is what the profiler reads."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(torch, prof.key_averages())
    return sum(e.self_device_time_total for e in kernels) / iters / 1e3


def gcn_record(torch, gcn, tree, launches, max_abs_err):
    """gcn_packed_matmul on the adjacency of real batches gathered from the
    store (the first training batch, B=16, and the first validation-sized
    batch, B=64) with x bf16 (B, 512, 128): kernel, plain, and the dense
    yardstick torch.bmm(Â bf16, x) (timed here, never called by the packed
    path), beside the bound from this run's bytes and operations.  Times
    are device times (``device_ms``: each call takes less device time than
    the host needs to issue it) in turns kernel, bmm, bmm, kernel; the
    CUDA-event time per call of back-to-back kernel calls is printed
    beside them."""
    from druglamp_tpu_torch.data.device_data import gather_compact_batch
    from druglamp_tpu_torch.data.encoding import decode_batch

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    record = None
    for B in (TRAIN_B, 64):
        rows = torch.arange(B, device=DEVICE)
        batch = decode_batch(gather_compact_batch(tree, rows, torch.ones(B, device=DEVICE),
                                                  False, False), keep_packed=True)
        packed, real = batch["drug_adj"]["packed"], batch["drug_adj"]["real"]
        deg = batch["drug_degrees"]
        nrm = torch.rsqrt(torch.clamp(deg, min=1.0))
        n2r = nrm * nrm * real
        N = packed.shape[1]
        x = torch.randn(B, N, 128, generator=g, device="cuda").to(torch.bfloat16)
        dense = ((nrm[:, :, None] * gcn.unpack_dense_adj(packed, real).float())
                 * nrm[:, None, :]).to(torch.bfloat16)
        kernel = lambda: gcn.gcn_packed_matmul(packed, nrm, n2r, x)       # noqa: E731
        plain = lambda: gcn.gcn_packed_plain(packed, nrm, n2r, x)         # noqa: E731
        library = lambda: torch.bmm(dense, x)                             # noqa: E731
        nnz = int((deg - real).sum().item())          # set bits: bonds + the single self-loops
        in_bytes = sum(t.numel() * t.element_size() for t in (packed, nrm, n2r, x))
        out_bytes = B * N * 128 * 4
        flops = 2 * 128 * (nnz + B * N)               # the set bits' products + the n2r term
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        turns = [("kernel", kernel), ("library", library), ("library", library), ("kernel", kernel)]
        times = {"kernel": [], "library": []}
        for label, fn in turns:
            times[label].append(device_ms(torch, fn))
        ms, library_ms = statistics.mean(times["kernel"]), statistics.mean(times["library"])
        plain_ms = device_ms(torch, plain)
        issue_ms = time_ms(torch, kernel)
        print(f"  gcn_packed_matmul bf16 B={B} N={N} C=128 ({nnz} set bits), device time per "
              f"call: kernel {ms * 1e3:.2f} us (turns "
              f"{', '.join('%.2f' % (t * 1e3) for t in times['kernel'])}), plain "
              f"{plain_ms * 1e3:.2f} us, dense bmm {library_ms * 1e3:.2f} us (turns "
              f"{', '.join('%.2f' % (t * 1e3) for t in times['library'])}), bound "
              f"{max(t_bytes, t_ops) * 1e3:.2f} us ({(in_bytes + out_bytes) / 1e6:.2f} MB, "
              f"{flops / 1e9:.4f} GFLOP); back-to-back kernel calls by CUDA events "
              f"{issue_ms * 1e3:.1f} us per call", flush=True)
        if B == TRAIN_B:
            record = {"name": "gcn_packed_matmul", "route": "cuda",
                      "source": "druglamp_tpu_torch/csrc/gcn_packed.cu",
                      "replaces": "druglamp_tpu/kernels/gcn_pallas.py:104",
                      "launches": launches["gcn_packed_matmul"]
                      + launches["gcn_packed_matmul_bwd"],
                      "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": library_ms}
    return record


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
    report = {f: r for text in logs.values() for f, r in ptxas_report(text).items()}
    for f, r in report.items():
        if "wgmma" in f:
            print(f"  tensor-core kernel {f}: {r}", flush=True)
            if r.get("spill_stores") or r.get("spill_loads"):
                fail(f"{f} spills registers: {r}")
    for D, n_sets in ((64, 2), (128, 1)):
        print(f"  bf16 backward kernels, D={D}, {n_sets} query set(s): "
              f"{attention.bwd_wgmma_occupancy(D, n_sets)}", flush=True)

    phase("3 kernels vs plain")
    serve_err = kernel_checks(torch, attention)
    train_err = backward_checks(torch, attention)
    determinism_checks(torch, attention)

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
    del model, state, step, batch

    phase("8 packed GCN kernel vs plain")
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.kernels import gcn

    gcn_err = gcn_checks(torch, gcn)

    phase("9 device-resident training epoch")
    print(f"  card: {smi}", flush=True)
    import tempfile

    cfg = Config()
    with tempfile.TemporaryDirectory() as root:
        train, val, data, emb = build_epoch_data(cfg, root)
    state, epoch, plan, epoch_launches = epoch_checks(torch, attention, gcn, cfg, train, val,
                                                      data, emb)
    epoch_timing(torch, state, epoch, plan, emb)
    records.append(gcn_record(torch, gcn, plan[2], epoch_launches, gcn_err))

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
