#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``druglamp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  Phases, each
printing its own lines; any failure exits non-zero and prints no result:

1. device  — needs ``torch.cuda.is_available()``; prints the card's name and
   ``nvidia-smi`` name and power limit; TF32 is switched off for matmuls and
   cuDNN, so the f32 comparisons below are true f32 (phase 6 checks the
   port's f32 forwards without that).
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
   run in f32 on the same bf16 inputs); two bf16 calls of the self forward
   (B=32 and 16) and of each backward (training shapes) give bit-identical
   results.
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
   atol 5e-5 and 3 losses within 1e-5.  The f32 forwards of ProteinCNN and
   DrugLAMP under torch's default TF32 settings and under matmul precision
   "high" within 2e-5 of TF32 off; two f32 steps from one seed, the second
   under those settings, bit-identical leaf by leaf (the same pair with
   cuDNN free to choose lists the leaves that differ).
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
   the training (16, 512, 128), eval (64, 512, 128) and small (3, 256, 64),
   (1, 64, 64) shapes: f32 atol = rtol = 1e-5; bf16 y within 1e-5 of its
   largest |y| and dx within one bf16 ulp; two bf16 calls bit-identical.
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
   the plain GCN and within rtol 2e-4 of the dense adjacency.  Two f32
   epochs from one seed: bit-identical losses and parameters.  The kernel
   beside its bound, its plain version and the dense ``torch.bmm``
   yardstick on real batches.  Then the epoch's pairs/s (CUDA events), host
   time to issue it, peak memory, and from one profiled epoch the
   device-busy share, the host → device bytes, the count of host reads of
   device values (must be 0) and of host waits for the device inside
   ``epoch_step``'s loop (the ``epoch_step.loop`` range; must be 0; tables
   in ``chiprun_out/epoch_profile.txt``), beside those inside the epoch
   call and those of an empty profiled block (the profiler's own); a
   positive control, one step whose batch gather waits for the card, must
   show its waits inside the loop.
10. full gate — DrugLAMP2C2P at ``Config()`` (bf16, seeded weights,
   ``DRUGLAMP_PACKED_GCN=1``): 10 steps of ``make_train_step(use_ssl=True,
   use_cm=True, calibrate=True)`` on a batch of 16 whose CM ground truth has
   positives, negatives and fallback rows, asserting 4/2 attention forward,
   4/2 backward (the cls loss only reaches PMMA), 3 GCN forward and 9 GCN
   backward launches a step (one per loss), finite losses, the CM weight a
   power of 10 times its start, and a non-zero gradient from its loss on
   every ``ssl_model`` and ``cm_model`` leaf.  Then in f32 with dropout 0,
   the step's forward and per-loss gradients through the kernels and
   through the plain attention and GCN: losses within 1e-5, each loss's
   gradients within rtol 5e-3 / atol 5e-5; two f32 full-gate steps from one
   seed (the second under TF32 settings) bit-identical; the bf16 step's
   CUDA-event time, host issue time, kernel time, launches and peak memory
   (table in ``chiprun_out/full_gate_profile.txt``).
11. fit     — ``Trainer.fit`` on phase 9's dataset (and its 128 test pairs),
   the DrugLAMP2C2P recipe with ssl and cm on, init_epoch 2, epoch_step 2,
   the packed GCN, 3 epochs (cls; ssl + cm + calibrate; cm) with the
   validation pass after each, then the test pass on the best state; the
   launches of every epoch and pass; each epoch's time (CUDA events),
   pairs/s, host issue time and peak memory; the same fit profiled: no host
   wait and no host read inside any epoch's loop (the calibrating one
   included), each epoch's kernel time; a Trainer whose model starts from
   other weights restores the epoch-2 ``ckpt_last.pt`` and trains epoch 3:
   its checkpoint equals the unbroken run's, leaf by leaf.
12. CLI     — ``druglamp_tpu_torch.cli.main.main(argv)`` in process on phase 9's
   dataset, ``Config()`` (bf16), ``DRUGLAMP_PACKED_GCN=1``, in the three
   transports the JAX CLI picks: (a) DrugLAMP2C2P, the recipe cut to 3 epochs
   (init_epoch 2, epoch_step 2), no embedding cache, so the host pipeline
   carries zero bf16 LLM arrays ((16, 512, 384) and (16, 1024, 640) a batch,
   one step call per batch); (b) the same with a seeded
   cache and ``--device-data off``: host batches of entity ordinals into the
   device store; (c) DrugLAMPwoLLM, 1 epoch, ``--device-data auto``: the
   device-resident dataset; (d) ``--eval-only`` on (a)'s ``ckpt_best.pt``
   with ``--allow-zero-embeddings``.  Each run profiled: every epoch's gates,
   finite losses and metrics, the five kernels' launches (4/2/4/2 attention
   and 3 GCN forwards a step, one GCN backward per loss, 4/2 + 3 an eval
   batch), no host wait and no host read inside any host loop
   (``trainer.host_epoch``, ``epoch_step.loop``); per epoch its time (CUDA
   events, under the profiler), pairs/s, host issue time, kernel time and
   busy share, host → device bytes and peak memory; (d)'s record equals
   (a)'s test metrics.

13. encoders — phase 9's dataset (37 real drugs, 64 proteins of 50–1022
   residues) through the frozen encoders, f32 in true f32: (a) ESM-2 t30 (30
   layers, 640 wide, 20 heads, FFN 2560) and ChemBERTa-77M-MTR (3 layers,
   384 wide, 12 heads, intermediate 464, 515 positions) with seeded weights
   on the card against the same modules on the CPU (the embedding
   pipeline's 8 × 1032 batch holding the 1022-residue protein: 1e-4; every
   drug: 2e-5), two card runs bit-identical, a protein alone against its
   row in the batch (1e-4); (b1) ``cli.main([... --gen-embed-only --esm-ckpt
   esm2_t30.pt --n-layer 30])`` from (a)'s ESM-2 weights written here in HF
   naming (the converter's table; ChemBERTa random init with the regex
   tokenizer): a finite cache of the right shape for every entity, equal to
   (a)'s CPU rows within the same tolerances, the sidecar; the same
   generation again under the profiler (bit-identical caches, each stage's
   kernel time); (b2) ``--gen-embed`` on the same work dir with phase 12's
   3-epoch recipe: nothing generated, the gather epochs over the device
   store, finite losses and test metrics, the five kernels' launches by
   phase 12's formula, no host wait or read inside a host loop; (c) each
   stage's seconds, entities/s, real tokens/s, padding share and busy share,
   peak memory, the card forward's TFLOP/s against its f32 bound, and the
   training epochs beside phase 12's.

Kernel times are device times from the profiler (``device_ms``), taken in
each phase before its profiled step or epoch; a timing window counts only
if every kernel record came back.

The second-to-last line is one JSON object with the kernel records; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
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
PROFILE_SETTLE_S = 0.05     # host wait at the end of a profiled block (``profiling``)
LEAD_IN_CYCLES = 40_000_000  # its lead-in spin kernel: 20 ms at 1.98 GHz
MARKER_CYCLES = 2_000_000   # ``device_ms``'s marker spin kernel: 1 ms
PROFILE_RETRIES = []        # windows that ``device_ms`` profiled again
START = time.perf_counter()

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
    print(f"== {name} (at {time.perf_counter() - START:.1f} s)", flush=True)


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
        # cover the other instantiations; self at B=1 (one tile per block) and L ≠ S
        (32, 4, 256, 256, 64, True), (32, 4, 256, 256, 128, False),
        (TRAIN_B, 4, 256, 256, 64, True), (TRAIN_B, 4, 256, 256, 128, False),
        (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False),
        (1, 4, 256, 256, 128, False), (2, 3, 200, 130, 128, False), (2, 2, 70, 300, 128, False),
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
    own = {"kernel": {"attention_fwd": launch_delta(torch, attention.LAUNCHES, kernel)},
           "library": None}
    times = {"kernel": [], "library": []}
    for label, fn in (("kernel", kernel), ("library", library), ("library", library),
                      ("kernel", kernel)):
        times[label].append(device_ms(torch, fn, own[label]))
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

    with torch.no_grad(), profiling(torch, cpu=True) as prof:
        predictor.model(batch)
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
    """Phase 3: two bf16 launches on the same inputs give bit-identical
    results (no atomics): the self forward (output and lse) at the serving
    and training shapes, and both backwards at the training shapes."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for B in (32, TRAIN_B):
        ops = make_operands(torch, g, B, 4, 256, 256, 128, torch.bfloat16, False)
        runs = [attention.launch_forward(*ops, None, with_lse=True) for _ in range(2)]
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(runs[0][0] + (runs[0][1],),
                                                  runs[1][0] + (runs[1][1],))]
        print(f"  self_attention_fwd bf16 B={B} H=4 L=S=256 D=128, two calls bit-identical: "
              f"{dict(zip(('o', 'lse'), same))}", flush=True)
        if not all(same):
            fail("self_attention_fwd: two calls on the same inputs differ")
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


@contextlib.contextmanager
def tf32_flags(torch, cudnn: bool, matmul: str):
    """torch's TF32 settings for the block (cuDNN's allow_tf32 and the f32
    matmul precision), restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.set_float32_matmul_precision(matmul)
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def tf32_checks(torch, F, cfg):
    """Phase 6: the f32 forwards of ProteinCNN (full width, batch 16) and of
    DrugLAMP (eval mode, the training batch) under torch's default TF32
    settings (cuDNN TF32 on) and under a caller's
    set_float32_matmul_precision("high") (matmul TF32 on), each within 2e-5
    of the same forward with TF32 off; the settings are the caller's again
    afterwards.  A bare F.conv1d under the default settings shows the error
    that TF32 gives, so the check can see it."""
    import dataclasses

    from druglamp_tpu_torch.data.encoding import decode_batch
    from druglamp_tpu_torch.nn.protein_cnn import ProteinCNN

    cfg32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                compute_dtype="float32"))
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    nh = cfg.n_hidden
    cnn = ProteinCNN(embedding_dim=nh, num_filters=(nh,) * 3, kernel_size=cfg.protein.kernel_size,
                     dtype=torch.float32)
    cnn.init_weights(torch.Generator().manual_seed(SEED))
    cnn = cnn.to(DEVICE).eval()
    v = torch.randint(0, 26, (TRAIN_B, cfg.protein.seq_len), generator=g, device=DEVICE)
    fill = (torch.rand(TRAIN_B, cfg.protein.seq_len, generator=g, device=DEVICE) < 0.1).float()
    model, _, _, batch = make_trainer(torch, cfg32)
    model.eval()
    decoded = decode_batch(dict(batch))
    xt = torch.randn(TRAIN_B, nh, cfg.protein.seq_len, generator=g, device=DEVICE)
    w = torch.randn(nh, nh, 9, generator=g, device=DEVICE) / 30
    forwards = {"ProteinCNN": lambda: cnn(v, fill),
                "DrugLAMP": lambda: model(decoded)["score"],
                "bare F.conv1d (no guard)": lambda: F.conv1d(xt, w)}
    with torch.no_grad(), tf32_flags(torch, False, "highest"):
        ref = {k: f() for k, f in forwards.items()}
    for cudnn, matmul in ((True, "highest"), (True, "high")):
        with torch.no_grad(), tf32_flags(torch, cudnn, matmul):
            got = {k: f() for k, f in forwards.items()}
            kept = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
        torch.cuda.synchronize()
        errs = {k: (got[k] - ref[k]).abs().max().item() for k in forwards}
        print(f"  f32 forwards, cudnn.allow_tf32={cudnn}, matmul precision {matmul!r}, against "
              f"TF32 off: " + ", ".join(f"{k} max |err| {e:.3e}" for k, e in errs.items())
              + " (tol 2e-5 for the port's forwards)", flush=True)
        if errs["ProteinCNN"] > 2e-5 or errs["DrugLAMP"] > 2e-5:
            fail("an f32 forward of the port runs in TF32 under the caller's settings")
        if kept != (cudnn, matmul):
            fail(f"the forward left the caller's TF32 settings changed: {kept}")
    del model, cnn


@contextlib.contextmanager
def cudnn_free():
    """The port's train steps with cuDNN free to pick nondeterministic
    algorithms, for the block only: ``steps.train_numerics`` without its
    deterministic setting (``true_f32`` alone), to name the ops that were at
    fault; the port has no such option."""
    from druglamp_tpu_torch.train import steps
    from druglamp_tpu_torch.utils.numerics import true_f32

    saved, steps.train_numerics = steps.train_numerics, true_f32
    try:
        yield
    finally:
        steps.train_numerics = saved


def f32_determinism(torch, cfg):
    """Phase 6: two f32 train steps from one seed (full width, dropout as
    configured, from one generator seed) give bit-identical parameters and
    gradients, leaf by leaf, the second step under torch's default cuDNN TF32
    and a caller's matmul precision "high" (the steps run in true f32,
    forward and backward).  The same pair under ``cudnn_free()`` lists the
    leaves that differ (the ops at fault), and one step of it under
    torch.use_deterministic_algorithms (warn_only) lists the ops torch flags;
    both are printed, not held."""
    import dataclasses
    import warnings

    from druglamp_tpu_torch.train.steps import make_train_step

    cfg32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                compute_dtype="float32"))

    def one_step(deterministic, tf32=False):
        model, state, _, batch = make_trainer(torch, cfg32)
        step = make_train_step(model, False, False)
        with contextlib.nullcontext() if deterministic else cudnn_free(), \
                tf32_flags(torch, tf32, "high" if tf32 else "highest"):
            step(state, batch, torch.Generator(device=DEVICE).manual_seed(SEED), TRAIN_LR)
        torch.cuda.synchronize()
        return ({n: p.detach().clone() for n, p in model.named_parameters()},
                {n: p.grad.clone() for n, p in model.named_parameters()})

    for deterministic in (True, False):
        (p1, g1), (p2, g2) = one_step(deterministic), one_step(deterministic, deterministic)
        differ = [n for n in p1 if not (torch.equal(p1[n], p2[n]) and torch.equal(g1[n], g2[n]))]
        names = ": " + ", ".join(differ[:12]) if differ else ""
        second = " (the second with cudnn.allow_tf32, precision high)" if deterministic else ""
        print(f"  f32 step twice from seed {SEED}, cuDNN deterministic={deterministic}{second}: "
              f"{len(p1)} leaves, {len(differ)} differ{names}", flush=True)
        if deterministic and differ:
            fail(f"two f32 steps from one seed differ: {differ[:5]}")
    saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            one_step(False)
    finally:
        torch.use_deterministic_algorithms(False)
        if saved_env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env
    flagged = sorted({str(w.message).split("\n")[0][:120] for w in caught
                      if "deterministic" in str(w.message)})
    print(f"  f32 step under torch.use_deterministic_algorithms(warn_only): "
          f"{len(flagged)} ops flagged{': ' + '; '.join(flagged) if flagged else ''}", flush=True)


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
    per_call = launch_delta(torch, attention.LAUNCHES, kernel)     # a dQ and a dK/dV kernel
    own = {"kernel": {"attention_dq": per_call, "attention_dkv": per_call}, "library": None}
    times = {"kernel": [], "library": []}
    for label, fn in (("kernel", kernel), ("library", library), ("library", library),
                      ("kernel", kernel)):
        times[label].append(device_ms(torch, fn, own[label]))
    ms, library_ms = statistics.mean(times["kernel"]), statistics.mean(times["library"])
    plain_ms = device_ms(torch, plain)
    issue = {"kernel": time_ms(torch, kernel), "library": time_ms(torch, library)}
    with profiling(torch) as prof:
        library()
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
    also shows as a device-side range over its kernels), without the
    lead-in ``spin_kernel`` of ``profiling``."""
    cpu_keys = {e.key for e in averages if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in cpu_keys and not getattr(e, "is_user_annotation", False)
            and "spin_kernel" not in e.key]


def train_timing(torch, attention, model, state, step, batch):
    """Phase 7: step time, pairs/s, peak memory, device-busy share, and a
    profiler table of one step."""
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

    with profiling(torch, cpu=True) as prof:
        run()
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


# train, eval, ragged small, one small graph
GCN_CASES = [(TRAIN_B, 512, 128), (64, 512, 128), (3, 256, 64), (1, 64, 64)]


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
                again = gcn.gcn_packed_matmul(packed, nrm, n2r, x)
                torch.cuda.synchronize()
                print(f"  gcn_packed_matmul bf16 B={B} N={N} C={C}, two calls bit-identical: "
                      f"{torch.equal(again, y)}", flush=True)
                if not torch.equal(again, y):
                    fail("gcn_packed_matmul: two calls on the same inputs differ")
    return train_err


EPOCH_PAIRS, VAL_PAIRS, N_PROTEINS, EVAL_B = 512, 128, 64, 64
FIT_EPOCHS = 3
F32_LR = 1e-5


def write_dataset(root: str):
    """A CSV dataset in the repo's layout (``<root>/synthetic/random/{train,
    val,test}.csv``): the real drugs of EPOCH_SMILES, N_PROTEINS proteins of
    50–1022 residues, EPOCH_PAIRS training, VAL_PAIRS validation and
    VAL_PAIRS test pairs, all drawn from SEED."""
    import numpy as np

    rng = np.random.RandomState(SEED + 5)
    prots = make_proteins(rng, N_PROTEINS)
    split = os.path.join(root, "synthetic", "random")
    os.makedirs(split)
    for name, n in (("train.csv", EPOCH_PAIRS), ("val.csv", VAL_PAIRS),
                    ("test.csv", VAL_PAIRS)):
        d = rng.randint(0, len(EPOCH_SMILES), size=n)
        p = rng.randint(0, N_PROTEINS, size=n)
        y = rng.randint(0, 2, size=n)
        rows = [f"{EPOCH_SMILES[a]},{prots[b]},{c}" for a, b, c in zip(d, p, y)]
        with open(os.path.join(split, name), "w") as f:
            f.write("\n".join(["SMILES,Protein,Y"] + rows) + "\n")


def seed_cache(path: str, table, cfg):
    """An EmbeddingCache at ``path`` of seeded random embeddings at the real
    token lengths (drugs len(SMILES)+2 rows capped at max_nodes, proteins
    min(len, max_resis)+2), 384 and 640 wide."""
    import numpy as np

    from druglamp_tpu_torch.data.cache import EmbeddingCache

    cache = EmbeddingCache(path, "synthetic")
    rng = np.random.RandomState(SEED + 6)
    for smi, o in table.drug2ord.items():
        cache.put_drug(o, rng.randn(min(len(smi) + 2, cfg.drug.max_nodes), 384))
    for seq, o in table.prot2ord.items():
        cache.put_prot(o, rng.randn(min(len(seq), cfg.protein.max_resis) + 2, 640))
    return cache


def build_epoch_data(cfg, root: str):
    """Datasets, an embedding cache of seeded random embeddings at the real
    token lengths (drugs len(SMILES)+2 rows capped at max_nodes, proteins
    min(len, max_resis)+2), and both device stores on the card."""
    from druglamp_tpu_torch.data.dataset import DTIDataset
    from druglamp_tpu_torch.data.device_data import DeviceDataStore
    from druglamp_tpu_torch.data.device_store import DeviceEmbeddingStore

    write_dataset(root)
    kw = dict(max_nodes=cfg.drug.max_nodes, max_prot_resis=cfg.protein.max_resis,
              seq_len=cfg.protein.seq_len)
    train = DTIDataset(root, "synthetic", "random", "train.csv", **kw)
    val = DTIDataset(root, "synthetic", "random", "val.csv", table=train.table, **kw)
    test = DTIDataset(root, "synthetic", "random", "test.csv", table=train.table, **kw)
    table = train.table
    cache = seed_cache(os.path.join(root, "embeddings"), table, cfg)
    emb = DeviceEmbeddingStore.build(table, cache, max_drug_tokens=cfg.drug.max_nodes,
                                     max_prot_len=cfg.protein.max_resis + 2, device=DEVICE)
    if emb is None:
        fail("DeviceEmbeddingStore over its budget")
    data = DeviceDataStore.build(table, cfg.drug.max_nodes, cfg.protein.seq_len, True, True,
                                 device=DEVICE)
    emb_bytes = sum(t.numel() * t.element_size() for t in emb.tree.values())
    print(f"  dataset: {table.n_drug} drugs, {table.n_prot} proteins, {len(train)} training, "
          f"{len(val)} validation and {len(test)} test pairs; DeviceDataStore {data.nbytes()} "
          f"bytes, "
          f"DeviceEmbeddingStore {emb_bytes} bytes (drug_emb "
          f"{tuple(emb.tree['drug_emb'].shape)}, prot_emb {tuple(emb.tree['prot_emb'].shape)})",
          flush=True)
    return train, val, test, data, emb.tree


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
    epoch_f32_determinism(torch, cfg, tree, emb, idx, ones)
    return state, epoch, (idx, ones, tree), launches


def epoch_f32_determinism(torch, cfg, tree, emb, idx, ones):
    """Two f32 epochs (the whole plan, packed GCN, dropout as configured, lr
    TRAIN_LR) from one seed: bit-identical losses and parameters."""
    import dataclasses

    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_epoch_step_gather

    cfg32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                compute_dtype="float32"))
    runs = []
    for _ in range(2):
        model = build_model("DrugLAMP", cfg32, generator=torch.Generator().manual_seed(SEED))
        epoch = make_epoch_step_gather(model, False, False, True, True, device=DEVICE)
        out = epoch(TrainState.create(model), idx, ones, tree, emb,
                    torch.Generator(device=DEVICE).manual_seed(SEED), TRAIN_LR)
        runs.append((out.cls_losses.cpu(),
                     {n: p.detach().clone() for n, p in model.named_parameters()}))
        del model, epoch, out
    (l1, p1), (l2, p2) = runs
    differ = [n for n in p1 if not torch.equal(p1[n], p2[n])]
    same = torch.equal(l1, l2)
    print(f"  f32 epoch twice from seed {SEED} ({len(idx)} steps, lr {TRAIN_LR}): losses "
          f"bit-identical {same} (last {l1[-1].item():.7f} / {l2[-1].item():.7f}); "
          f"{len(p1)} parameters, {len(differ)} differ", flush=True)
    if not same or differ:
        fail(f"two f32 epochs from one seed differ: {differ[:5]}")


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


# CUDA runtime calls that make the host wait for the device
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def waits_inside(torch, prof, span: str):
    """Count of each HOST_WAITS call inside the one host range ``span`` of a
    profiled run (``loop_counts``' reading; None unless there is one range)."""
    ranges = loop_counts(torch, prof, span, HOST_WAITS)
    return ranges[0][0] if len(ranges) == 1 else None


def wait_control(torch, epoch, state, plan, emb, gen):
    """The positive control of the in-loop count: a one-step epoch whose
    batch gather also copies the plan from pageable memory (what the epoch
    did before it staged the plan in pinned memory) and synchronises, inside
    ``epoch_step.loop``.  Returns the count ``waits_inside`` reads there."""
    import numpy as np

    from druglamp_tpu_torch.train import steps

    idx, ones, tree = plan
    gather = steps.gather_compact_batch

    def waiting_gather(*args, **kwargs):
        torch.as_tensor(np.asarray(idx[:1]), device=DEVICE)
        torch.cuda.synchronize()
        return gather(*args, **kwargs)

    steps.gather_compact_batch = waiting_gather
    try:
        with profiling(torch, cpu=True) as prof:
            epoch(state, idx[:1], ones[:1], tree, emb, gen, TRAIN_LR)
    finally:
        steps.gather_compact_batch = gather
    return waits_inside(torch, prof, "epoch_step.loop")


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

    with profiling(torch, cpu=True) as prof:
        with torch.profiler.record_function("chip_smoke.epoch_call"):
            epoch(state, idx, ones, tree, emb, gen, TRAIN_LR)
    averages = prof.key_averages()
    kernels = device_kernels(torch, averages)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    syncs = {k: sum(e.count for e in averages if e.key == k)
             for k in ("aten::item", "aten::_local_scalar_dense")}
    waits = {k: sum(e.count for e in averages if e.key == k) for k in HOST_WAITS}
    loop_waits = waits_inside(torch, prof, "epoch_step.loop")
    call_waits = waits_inside(torch, prof, "chip_smoke.epoch_call")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as empty:
        pass
    own_waits = {k: sum(e.count for e in empty.key_averages() if e.key == k) for k in HOST_WAITS}
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
          f"(the closing torch.cuda.synchronize included), inside epoch_step's loop "
          f"{loop_waits}, inside the epoch call {call_waits}; "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    print(f"  host waits of an empty profiled block (the profiler's own on closing): "
          f"{own_waits}", flush=True)
    print("  our kernels in the epoch (ms of device time): "
          + ", ".join(f"{n} {t:.3f}" for n, t in ours.items()), flush=True)
    if any(syncs.values()):
        fail(f"the epoch reads device values back to the host: {syncs}")
    if loop_waits is None:
        fail("the profiled epoch has not one epoch_step.loop range")
    if any(loop_waits.values()):
        fail(f"the host waits for the device inside epoch_step's loop: {loop_waits}")
    control = wait_control(torch, epoch, state, plan, emb, gen)
    print(f"  control, one step whose gather copies the plan from pageable memory and "
          f"synchronises: inside epoch_step's loop {control}", flush=True)
    if not control or not control["cudaDeviceSynchronize"] or not (
            control["cudaStreamSynchronize"] or control["cudaMemcpy"]):
        fail(f"the in-loop count misses waits placed inside epoch_step's loop: {control}")


# --- phases 10 and 11: the full DrugLAMP2C2P recipe ------------------------------------

SSL_LR, CM_LR, MARGIN = 3e-5, 3e-5, 0.5        # the DrugLAMP2C2P recipe's
# kernel launches of one full-gate step (DrugLAMP2C2P, packed GCN): the
# attention backwards for the cls loss only, the GCN backward once for each
# of the three losses (each reaches the GCN tokens)
FULL_GATE_PER_STEP = {"paired_attention_fwd": 4, "self_attention_fwd": 2,
                      "paired_attention_bwd": 4, "self_attention_bwd": 2,
                      "gcn_packed_matmul": 3, "gcn_packed_matmul_bwd": 9}


def full_gate_batch(torch, cfg):
    """One compact batch of TRAIN_B from make_batch, with CM ground truth from
    5 proteins and 7 drugs: proteins 0–3 have positives and negatives,
    protein 4 negatives only (the triplet loss's fallback rows)."""
    import numpy as np

    from druglamp_tpu_torch.data.encoding import compact_batch
    from druglamp_tpu_torch.data.loader import build_cm_arrays
    from druglamp_tpu_torch.utils.synthetic import make_batch

    host = make_batch(cfg, TRAIN_B, seed=SEED, n_drug_feature=384, n_prot_feature=640)
    batch = compact_batch(host, (host["d_fill"] == 0).sum(1))
    t = np.arange(TRAIN_B)
    pid, did = t % 5, t % 7
    batch["labels"] = ((t % 3 == 0) & (pid != 4)).astype(np.float32)
    cm = build_cm_arrays(pid, did, batch["labels"])
    out = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    out["cm"] = {k: torch.from_numpy(v).to(DEVICE) for k, v in cm.items()}
    return out


def make_full_gate(torch, cfg):
    """(model, state, step) for DrugLAMP2C2P at ``cfg``, weights drawn from
    SEED, the full-gate step (ssl, cm, calibrate)."""
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_train_step

    model = build_model("DrugLAMP2C2P", cfg, generator=torch.Generator().manual_seed(SEED))
    step = make_train_step(model, True, True, calibrate=True, device=DEVICE)
    return model, TrainState.create(model, True, True), step


def full_gate_gradients(torch, model, batch, seed):
    """The per-loss gradients of one full-gate step's forward (the step's own
    first half, ``steps.loss_gradients``) under the step's numerics."""
    from druglamp_tpu_torch.data.encoding import decode_batch
    from druglamp_tpu_torch.train import steps

    model.train()
    with steps.train_numerics():
        decoded = decode_batch(dict(batch))
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        return steps.loss_gradients(model, decoded, gen, True, True, True, MARGIN,
                                    torch.ones((), device=DEVICE))


def full_gate_checks(torch, attention, gcn):
    """Phase 10: TRAIN_STEPS full-gate steps at full width (bf16, packed GCN)
    → launch counts of the main path."""
    import dataclasses

    from druglamp_tpu_torch.config import Config

    os.environ["DRUGLAMP_PACKED_GCN"] = "1"
    cfg = Config()
    model, state, step = make_full_gate(torch, cfg)
    batch = full_gate_batch(torch, cfg)
    gt = batch["cm"]["gt"]
    n_pos = int((gt == 1).any(1).sum().item())
    n_fb = int(((gt == 0).any(1) & ~(gt == 1).any(1)).sum().item())
    print(f"  DrugLAMP2C2P at Config(), {cfg.solver.compute_dtype}, DRUGLAMP_PACKED_GCN=1, "
          f"{sum(p.numel() for p in model.parameters())} parameters; batch of {TRAIN_B}, CM "
          f"ground truth: {n_pos} proteins with positives, {n_fb} fallback (negatives only); "
          f"{TRAIN_STEPS} steps of make_train_step(use_ssl, use_cm, calibrate) at lr "
          f"{TRAIN_LR}/{SSL_LR}/{CM_LR}, margin {MARGIN}", flush=True)
    if not n_pos or not n_fb:
        fail("the full-gate batch lacks positives or a fallback row")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    w0 = 1e-3          # the calibration's second loop moves it to the losses' scale
    w = w0
    reset_counts(attention, gcn)
    outs = []
    for _ in range(TRAIN_STEPS):
        outs.append(step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, w))
        w = outs[-1].cm_weight
    torch.cuda.synchronize()
    launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
    print(f"  main path: {TRAIN_STEPS} full-gate steps, launches {launches}", flush=True)
    if launches != {k: TRAIN_STEPS * v for k, v in FULL_GATE_PER_STEP.items()}:
        fail(f"full-gate launches {launches}, expected {FULL_GATE_PER_STEP} per step")
    losses = {k: [float(getattr(o, k)) for o in outs] for k in ("cls_loss", "ssl_loss", "cm_loss")}
    for k, v in losses.items():
        print(f"  {k}: {['%.6f' % x for x in v]}", flush=True)
        if not all(math.isfinite(x) for x in v):
            fail(f"non-finite {k}")
    ratio = float(w) / w0
    k10 = round(math.log10(ratio))
    print(f"  cm_weight {float(w)!r} = {ratio / 10.0 ** k10:.7f}·10^{k10} times its start",
          flush=True)
    if abs(ratio / 10.0 ** k10 - 1) > 1e-6:
        fail(f"cm_weight {float(w)} is not a power of 10 times {w0}")

    *_, grads = full_gate_gradients(torch, model, batch, SEED + 1)
    names = [n for n, _ in model.named_parameters()]
    reach = {"ssl": "ssl_model.", "cm": "cm_model."}
    zero = []
    for loss, prefix in reach.items():
        leaves = [(n, g) for n, g in zip(names, grads[loss]) if n.startswith(prefix)]
        zero += [n for n, g in leaves if g.abs().max().item() == 0 or not torch.isfinite(g).all()]
        print(f"  {loss} gradient: {len(leaves)} {prefix[:-1]} leaves, "
              f"{sum(1 for n, g in leaves if g.abs().max().item() > 0)} non-zero", flush=True)
    if zero:
        fail(f"head leaves without a finite non-zero gradient from their loss: {zero[:5]}")

    cfg32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                compute_dtype="float32"))
    full_gate_f32_agreement(torch, attention, gcn, dataclasses.replace(cfg32, pmma_dropout=0.0))
    full_gate_f32_determinism(torch, cfg32)
    full_gate_timing(torch, model, state, step, batch, w)
    del model, state, step
    return launches


def full_gate_f32_agreement(torch, attention, gcn, cfg32):
    """The full-gate step's forward and per-loss gradients in f32, dropout 0,
    the same MLM draws, through the kernels and through the plain versions
    (attention and GCN): each loss within 1e-5, each loss's gradient within
    rtol 5e-3 / atol 5e-5, leaf by leaf."""
    runs = []
    batch = full_gate_batch(torch, cfg32)
    for plain in (False, True):
        from druglamp_tpu_torch.models.registry import build_model

        model = build_model("DrugLAMP2C2P", cfg32, generator=torch.Generator().manual_seed(SEED))
        model.to(DEVICE)
        reset_counts(attention, gcn)
        with (plain_attention(attention) if plain else contextlib.nullcontext()), \
                (plain_gcn(gcn) if plain else contextlib.nullcontext()):
            cls, ssl, cm, _, w, grads = full_gate_gradients(torch, model, batch, SEED)
        torch.cuda.synchronize()
        bwd = (attention.LAUNCHES["paired_attention_bwd"]
               + attention.LAUNCHES["self_attention_bwd"], gcn.LAUNCHES["gcn_packed_matmul_bwd"])
        if (bwd == (0, 0)) != plain or (not plain and bwd != (6, 9)):
            fail(f"f32 full gate ({'plain' if plain else 'kernels'}): backward launches {bwd}")
        runs.append(([float(cls), float(ssl), float(cm)], float(w), grads))
        del model
    (lk, wk, gk), (lp, wp, gp) = runs
    worst, bad = 0.0, []
    for loss in ("cls", "ssl", "cm"):
        for i, (a, b) in enumerate(zip(gk[loss], gp[loss])):
            worst = max(worst, (a - b).abs().max().item())
            if not torch.allclose(a, b, rtol=5e-3, atol=5e-5):
                bad.append((loss, i))
    dloss = max(abs(a - b) for a, b in zip(lk, lp))
    print(f"  f32 full gate, dropout 0, kernels vs plain attention and GCN: losses "
          f"{['%.7f' % x for x in lk]} vs {['%.7f' % x for x in lp]}, max |Δ| {dloss:.3e} "
          f"(tol 1e-5); cm_weight {wk!r} vs {wp!r}; 3 × {len(gk['cls'])} gradient leaves, max "
          f"|Δg| {worst:.3e} (rtol 5e-3, atol 5e-5), {len(bad)} outside", flush=True)
    if bad or dloss > 1e-5 or wk != wp:
        fail(f"the f32 full-gate step disagrees with its plain run: {bad[:5]}, "
             f"|Δloss| {dloss:.3e}")


def full_gate_f32_determinism(torch, cfg32):
    """Two f32 full-gate steps from one seed (dropout as configured, the same
    generator seed for dropout and the MLM draws), the second under cuDNN
    TF32 and matmul precision "high": parameters, BatchNorm buffers, the
    gradients left in .grad and the three losses bit-identical."""
    runs = []
    for tf32 in (False, True):
        model, state, step = make_full_gate(torch, cfg32)
        batch = full_gate_batch(torch, cfg32)
        with tf32_flags(torch, tf32, "high" if tf32 else "highest"):
            out = step(state, batch, torch.Generator(device=DEVICE).manual_seed(SEED), TRAIN_LR,
                       SSL_LR, CM_LR, MARGIN, 1.0)
        torch.cuda.synchronize()
        runs.append(({k: v.detach().clone() for k, v in model.state_dict().items()},
                     {n: p.grad.clone() for n, p in model.named_parameters()},
                     [float(out.cls_loss), float(out.ssl_loss), float(out.cm_loss)]))
        del model, state, step
    (s1, g1, l1), (s2, g2, l2) = runs
    differ = [k for k in s1 if not torch.equal(s1[k], s2[k])]
    differ += [f"grad:{n}" for n in g1 if not torch.equal(g1[n], g2[n])]
    print(f"  f32 full-gate step twice from seed {SEED} (the second under cudnn.allow_tf32, "
          f"precision high): {len(s1)} state leaves and {len(g1)} gradients, {len(differ)} "
          f"differ; losses {l1} / {l2}", flush=True)
    if differ or l1 != l2:
        fail(f"two f32 full-gate steps from one seed differ: {differ[:5]}")


def full_gate_timing(torch, model, state, step, batch, w):
    """The bf16 full-gate step (calibration included): CUDA-event time, host
    issue time, kernel time and launches of one profiled step, peak memory."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    run = lambda: step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, w)   # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, run, iters=TRAIN_STEPS, reps=3, warmup=2)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        run()
    issue_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    torch.cuda.synchronize()
    with profiling(torch, cpu=True) as prof:
        run()
    averages = prof.key_averages()
    kernels = device_kernels(torch, averages)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    n_ops = sum(e.count for e in averages
                if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::"))
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "full_gate_profile.txt"), "w") as f:
        f.write(averages.table(sort_by="self_device_time_total", row_limit=40))
        f.write("\n\nThe same step by self CPU time (host work):\n")
        f.write(averages.table(sort_by="self_cpu_time_total", row_limit=40))
    print(f"  full-gate step (bf16, batch {TRAIN_B}, calibration included, CUDA events, median of "
          f"3 x {TRAIN_STEPS}): {step_ms:.2f} ms, {TRAIN_B / step_ms * 1e3:.1f} pairs/s; host "
          f"time to issue a step {issue_ms:.2f} ms; kernel time {busy_ms:.2f} ms "
          f"({busy_ms / step_ms:.1%} busy); {n_kernels} kernel launches and {n_ops} aten op "
          f"calls a step; peak device memory {peak_gib:.2f} GiB", flush=True)


def loop_counts(torch, prof, span: str, names):
    """For each host range ``span`` of a profiled run, in order: the count of
    each of ``names`` among the host calls inside it, and the kernel time
    (ms) of the kernels that start inside it or within 20 ms after it.  Read
    from the profiler's raw records: building its event tree for a whole fit
    (some two million records) takes minutes."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    ranges = sorted((e.start_ns(), e.end_ns()) for e in raw
                    if e.name() == span and e.device_type() == cpu)
    out = [(dict.fromkeys(names, 0), 0.0) for _ in ranges]
    for e in raw:
        name, start = e.name(), e.start_ns()
        if e.device_type() == cpu and name in names:
            for i, (a, b) in enumerate(ranges):
                if a <= start and e.end_ns() <= b:
                    out[i][0][name] += 1
        elif e.device_type() == cuda and not e.is_user_annotation() and "spin_kernel" not in name:
            for i, (a, b) in enumerate(ranges):
                if a <= start <= b + 20_000_000:
                    out[i] = (out[i][0], out[i][1] + e.duration_ns() / 1e6)
    return out


# phase 11's epoch records and test metrics, which phase 12's run (b) repeats
# over the host pipeline
FIT_RESULT = {}


def fit_checks(torch, attention, gcn, train, val, test, data, emb):
    """Phase 11: ``Trainer.fit`` → launch counts of the main path."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.loader import BatchLoader
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.trainer import Trainer
    from druglamp_tpu_torch.utils.logging import ExperimentLogger

    os.environ["DRUGLAMP_PACKED_GCN"] = "1"
    base = Config()
    cfg = dataclasses.replace(
        base, rs=dataclasses.replace(base.rs, ssl=True, cm=True, init_epoch=2, epoch_step=2),
        solver=dataclasses.replace(base.solver, max_epoch=FIT_EPOCHS, ckpt_every=1,
                                   cm_lr=CM_LR, eval_batch_size=EVAL_B))
    loaders = (BatchLoader(train, TRAIN_B, shuffle=True, drop_last=True, seed=SEED),
               BatchLoader(val, EVAL_B, shuffle=False, drop_last=False),
               BatchLoader(test, EVAL_B, shuffle=False, drop_last=False))
    S = len(loaders[0])
    print(f"  DrugLAMP2C2P at Config(), bf16, DRUGLAMP_PACKED_GCN=1; Trainer.fit over "
          f"{FIT_EPOCHS} epochs of {S} steps (ssl and cm on, init_epoch 2, epoch_step 2: cls, "
          f"then ssl+cm+calibrate, then cm), validation after each, then the test pass on the "
          f"best state", flush=True)

    def trainer(work, seed, logger=None, ckpt_every=1):
        c = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, ckpt_every=ckpt_every))
        model = build_model("DrugLAMP2C2P", c, generator=torch.Generator().manual_seed(seed))
        t = Trainer(model, c, *loaders, logger=logger, work_dir=work, embed_store=emb,
                    device_data=data, device=DEVICE)
        # the recipe's early-stopping patience (max_epoch // 4 of its 100
        # epochs): a 3-epoch cut would stop after one epoch without a gain
        t.patience = base.solver.max_epoch // 4
        return t, TrainState.create(model, True, True)

    with tempfile.TemporaryDirectory() as tmp:
        # the unbroken fit, each epoch timed; its epoch-2 ckpt_last kept
        log = ExperimentLogger(tmp, "fit", quiet=True)
        t, state = trainer(os.path.join(tmp, "unbroken"), SEED, log)
        timings, epoch2 = [], os.path.join(tmp, "ckpt_epoch2.pt")
        build_fn, save = t._epoch_fn, t._save

        def timed_epoch_fn(*key):
            fn = build_fn(*key)

            def run(*args, **kwargs):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                issue = time.perf_counter() - t0
                end.record()
                end.synchronize()
                timings.append((start.elapsed_time(end), issue * 1e3,
                                torch.cuda.max_memory_allocated() / 2 ** 30))
                return out
            return run

        def save_keeping_epoch2(path, snapshot):
            save(path, snapshot)
            if path.endswith("ckpt_last.pt") and t.epoch == 2:
                shutil.copy(path, epoch2)

        t._epoch_fn, t._save = timed_epoch_fn, save_keeping_epoch2
        t_fit = time.perf_counter()
        reset_counts(attention, gcn)
        test_metrics = t.run_experiment(SEED, state=state)
        torch.cuda.synchronize()
        launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
        with open(log.jsonl_path) as f:
            records = [json.loads(line) for line in f]
        epochs = [r for r in records if "train_loss" in r]
        FIT_RESULT.update(epochs=epochs, test=test_metrics, best_epoch=t.best_epoch)
        print(f"  main path, fit and test: launches {launches}", flush=True)
        gates = [("ssl_loss" in r, "cm_loss" in r) for r in epochs]
        if gates != [(False, False), (True, True), (False, True)][:FIT_EPOCHS]:
            fail(f"the epochs' gates {gates}, expected cls, ssl+cm, cm")
        per_step = {"paired_attention_fwd": 4, "self_attention_fwd": 2,
                    "paired_attention_bwd": 4, "self_attention_bwd": 2, "gcn_packed_matmul": 3}
        n_eval = -(-len(val) // EVAL_B) * FIT_EPOCHS + -(-len(test) // EVAL_B)
        want = {k: S * FIT_EPOCHS * v for k, v in per_step.items()}
        want["paired_attention_fwd"] += 4 * n_eval
        want["self_attention_fwd"] += 2 * n_eval
        want["gcn_packed_matmul"] += 3 * n_eval
        want["gcn_packed_matmul_bwd"] = S * (3 + 9 + 6)       # cls; cls+ssl+cm; cls+cm
        if launches != want:
            fail(f"fit launches {launches}, expected {want}")
        for r, (ms, issue, peak) in zip(epochs, timings):
            print(f"  epoch {r['epoch']}: cls {r['train_loss']:.5f}"
                  + (f", ssl {r['ssl_loss']:.5f}" if "ssl_loss" in r else "")
                  + (f", cm {r['cm_loss']:.5f} (weight {r['cm_weight']!r}, margin "
                     f"{r['margin']:.5f})" if "cm_loss" in r else "")
                  + f"; val AUROC {r['val_auroc']:.4f}, AUSum {r['val_ausum']:.4f}; epoch call "
                  f"{ms:.1f} ms (CUDA events), {S * TRAIN_B / ms * 1e3:.1f} pairs/s, host time "
                  f"to issue it {issue:.1f} ms, peak device memory {peak:.2f} GiB; epoch with "
                  f"its loss sums {r['epoch_time_s'] * 1e3:.1f} ms", flush=True)
            if not all(math.isfinite(r[k]) for k in ("train_loss", "ssl_loss", "cm_loss")
                       if k in r):
                fail(f"non-finite losses in epoch {r['epoch']}")
        ratio = t.cm_weight / 1.0
        if abs(ratio / 10.0 ** round(math.log10(ratio)) - 1) > 1e-6:
            fail(f"cm_weight {t.cm_weight} is not a power of 10")
        print(f"  test on the best state (epoch {t.best_epoch}): AUROC "
              f"{test_metrics['auroc']:.4f}, AUPRC {test_metrics['auprc']:.4f}, loss "
              f"{test_metrics['loss']:.5f}", flush=True)
        if not all(math.isfinite(test_metrics[k]) for k in ("auroc", "auprc", "loss")):
            fail(f"test metrics not finite: {test_metrics}")
        final = torch.load(os.path.join(tmp, "unbroken", "ckpt_last.pt"), map_location=DEVICE,
                           weights_only=True)

        print(f"  (the timed fit and test took {time.perf_counter() - t_fit:.1f} s)", flush=True)

        # the same fit profiled (checkpoints only when it stops): host waits
        # and reads inside each epoch's loop
        t_prof = time.perf_counter()
        tp, state = trainer(os.path.join(tmp, "profiled"), SEED, ckpt_every=FIT_EPOCHS)
        with profiling(torch, cpu=True) as prof:
            tp.fit(state, SEED)
        names = HOST_WAITS + ("aten::item", "aten::_local_scalar_dense")
        loops = loop_counts(torch, prof, "epoch_step.loop", names)
        print(f"  (the profiled fit and its count took {time.perf_counter() - t_prof:.1f} s)",
              flush=True)
        if len(loops) != FIT_EPOCHS:
            fail(f"the profiled fit shows {len(loops)} epoch_step.loop ranges")
        for i, ((counts, busy), (ms, _, _)) in enumerate(zip(loops, timings)):
            print(f"  epoch {i + 1} profiled: inside its loop host waits "
                  f"{ {k: counts[k] for k in HOST_WAITS} }, host reads "
                  f"{counts['aten::item'] + counts['aten::_local_scalar_dense']}; kernel time "
                  f"{busy:.1f} ms, {busy / ms:.1%} of the unprofiled epoch call", flush=True)
            if any(counts.values()):
                fail(f"epoch {i + 1} waits for or reads from the device inside its loop: {counts}")

        # a resume from the epoch-2 ckpt_last, in a Trainer whose model starts elsewhere
        resume_dir = os.path.join(tmp, "resumed")
        os.makedirs(resume_dir)
        shutil.copy(epoch2, os.path.join(resume_dir, "ckpt_last.pt"))
        tr, state = trainer(resume_dir, SEED + 1)
        tr.restore(os.path.join(resume_dir, "ckpt_last.pt"), state)
        tr.fit(state, SEED, start_epoch=tr.epoch + 1)
        resumed = torch.load(os.path.join(resume_dir, "ckpt_last.pt"), map_location=DEVICE,
                             weights_only=True)
        differ = [k for k in final["model"] if not torch.equal(final["model"][k],
                                                               resumed["model"][k])]
        for opt in ("opt_cls", "opt_ssl", "opt_cm"):
            a, b = final["optim"][opt]["state"], resumed["optim"][opt]["state"]
            differ += [f"{opt}:{i}:{k}" for i in a for k in a[i]
                       if not torch.equal(torch.as_tensor(a[i][k]), torch.as_tensor(b[i][k]))]
        same_host = final["host"] == resumed["host"]
        print(f"  resume from the epoch-2 ckpt_last: epoch 3 against the unbroken run's, "
              f"{len(final['model'])} model leaves and the three AdamW states, {len(differ)} "
              f"differ; host state equal {same_host}", flush=True)
        if differ or not same_host:
            fail(f"the resumed epoch 3 differs from the unbroken one: {differ[:5]}")
    del t, tp, tr
    return launches


# --- phase 12: the training CLI --------------------------------------------------------

# the host ranges inside which nothing may wait for the card or read from it:
# the Trainer's host epoch loop and eval pass, and the epoch drivers' step loop
HOST_LOOPS = ("trainer.host_epoch", "epoch_step.loop")
HOST_READS = ("aten::item", "aten::_local_scalar_dense")


def span_stats(torch, prof, spans, names):
    """For each host range of each of ``spans`` in a profiled run, in order:
    the count of each of ``names`` among the host calls inside it, and the
    time (ms) of the device's records that start inside it (kernels and
    memory copies) and the count of its host → device copies.  One pass over
    the profiler's raw records; each span's ranges are disjoint, so a record
    is looked up by bisection."""
    import bisect

    cpu = torch.autograd.DeviceType.CPU
    raw = prof.profiler.kineto_results.events()
    ranges = {sp: sorted((e.start_ns(), e.end_ns()) for e in raw
                         if e.name() == sp and e.device_type() == cpu) for sp in spans}
    starts = {sp: [a for a, _ in r] for sp, r in ranges.items()}
    out = {sp: [dict(dict.fromkeys(names, 0), kernel_ms=0.0, h2d_copies=0) for _ in r]
           for sp, r in ranges.items()}
    names = set(names)
    for e in raw:
        name, start = e.name(), e.start_ns()
        on_host = e.device_type() == cpu
        if on_host and name not in names:
            continue
        if not on_host and (e.is_user_annotation() or "spin_kernel" in name):
            continue
        for sp in spans:
            i = bisect.bisect_right(starts[sp], start) - 1
            if i < 0:
                continue
            a, b = ranges[sp][i]
            if on_host:
                if e.end_ns() <= b:
                    out[sp][i][name] += 1
            elif start <= b:
                out[sp][i]["kernel_ms"] += e.duration_ns() / 1e6
                out[sp][i]["h2d_copies"] += "HtoD" in name
    return out


def cli_yaml(root: str, model: str, epochs: int) -> str:
    """The built-in recipe of ``model`` cut to ``epochs`` epochs, with
    init_epoch 2 and epoch_step 2 (phase 11's cut), as a YAML for --config."""
    import yaml

    from druglamp_tpu_torch.config import builtin_config_path

    with open(builtin_config_path(model)) as f:
        tree = yaml.safe_load(f)
    tree["SOLVER"]["MAX_EPOCH"] = epochs
    tree["RS"].update(INIT_EPOCH=2, EPOCH_STEP=2)
    path = os.path.join(root, f"{model}_{epochs}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(tree, f)
    return path


@contextlib.contextmanager
def epoch_hooks(torch, log):
    """Time each epoch the Trainer runs (any transport): its call by CUDA
    events, the host time until its results are read back (the time to
    issue it), peak device memory, and the host → device bytes its data path
    hands to ``to_device``; each epoch inside a ``chip_smoke.epoch`` range."""
    from druglamp_tpu_torch.train import steps
    from druglamp_tpu_torch.train import trainer as trainer_mod

    Trainer = trainer_mod.Trainer
    saved = {n: getattr(Trainer, n) for n in ("_fit_epoch_host", "_fit_epoch_gather",
                                               "_read_epoch")}
    saved_to = (steps.to_device, trainer_mod.to_device)
    cur = {}

    def counting_to_device(batch, device, keep=None):
        if device.type == "cuda":
            def add(v):
                if not isinstance(v, torch.Tensor) or v.device.type == "cpu":
                    cur["h2d"] = cur.get("h2d", 0) + getattr(v, "nbytes", 0)
            steps.tree_map(add, batch)
        return saved_to[0](batch, device, keep)

    def timed(name):
        fn = saved[name]

        def run(self, *args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cur.clear()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            t0 = time.perf_counter()
            with torch.profiler.record_function("chip_smoke.epoch"):
                out = fn(self, *args, **kwargs)
            end.record()
            end.synchronize()
            log.append({"transport": self.transport, "ms": start.elapsed_time(end),
                        "issue_ms": (cur.get("read", time.perf_counter()) - t0) * 1e3,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "h2d_issued": cur.get("h2d", 0), "steps": out[1]})
            return out
        return run

    def read_epoch(self, *args, **kwargs):
        cur["read"] = time.perf_counter()
        return saved["_read_epoch"](self, *args, **kwargs)

    for n in ("_fit_epoch_host", "_fit_epoch_gather"):
        setattr(Trainer, n, timed(n))
    Trainer._read_epoch = read_epoch
    steps.to_device = trainer_mod.to_device = counting_to_device
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(Trainer, n, fn)
        steps.to_device, trainer_mod.to_device = saved_to


CLI_EPOCHS = {}     # phase 12's epochs by run: (epoch, transport, ms), printed in phase 13
CLI_PER_STEP = {"paired_attention_fwd": 4, "self_attention_fwd": 2,
                "paired_attention_bwd": 4, "self_attention_bwd": 2, "gcn_packed_matmul": 3}
CLI_PER_EVAL_BATCH = {"paired_attention_fwd": 4, "self_attention_fwd": 2, "gcn_packed_matmul": 3}


def want_launches(gates, S: int, n_eval: int) -> dict:
    """The launches of a CLI training run whose epochs ran ``gates`` ((ssl,
    cm) each) at ``S`` steps, with a validation pass of ``n_eval`` batches
    after each epoch and the test pass: 4/2/4/2 attention and 3 GCN forwards
    a step, one GCN backward per loss, 4/2 + 3 an eval batch."""
    n = len(gates)
    want = {k: v * (S * n + n_eval * (n + 1)) for k, v in CLI_PER_EVAL_BATCH.items()}
    for k in ("paired_attention_bwd", "self_attention_bwd"):
        want[k] = CLI_PER_STEP[k] * S * n
    want["gcn_packed_matmul_bwd"] = S * sum(3 * (1 + ssl + cm) for ssl, cm in gates)
    return want


def cli_run(torch, attention, gcn, label, argv, cwd):
    """One in-process call of ``druglamp_tpu_torch.cli.main.main(argv)``
    (working directory ``cwd``), profiled: → (rc, its epochs' log, launches,
    the per-range stats of its epochs and host loops, wall seconds)."""
    from druglamp_tpu_torch.cli import main as cli

    log = []
    reset_counts(attention, gcn)
    here = os.getcwd()
    t0 = time.perf_counter()
    os.chdir(cwd)
    try:
        with epoch_hooks(torch, log), profiling(torch, cpu=True) as prof:
            rc = cli.main(argv)
    finally:
        os.chdir(here)
    wall = time.perf_counter() - t0
    launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
    stats = span_stats(torch, prof, ("chip_smoke.epoch",) + HOST_LOOPS,
                       HOST_WAITS + HOST_READS)
    print(f"  ({label}: {wall:.1f} s with the profiler on, rc {rc}; launches {launches})",
          flush=True)
    return rc, log, launches, stats


def check_host_loops(label, stats) -> None:
    """No host wait and no host read inside any host loop range."""
    for span in HOST_LOOPS:
        bad = [{k: c[k] for k in HOST_WAITS + HOST_READS if c[k]} for c in stats[span]]
        print(f"  {label}: {len(stats[span])} {span} ranges, host waits / reads inside "
              f"them {sum(len(b) > 0 for b in bad)} ranges with any "
              f"({[b for b in bad if b][:3]})", flush=True)
        if any(bad):
            fail(f"{label} waits for or reads from the card inside {span}: {bad}")


def print_epochs(label, records, log, stats, batch_size) -> None:
    """Each epoch: gates, losses, validation AUSum, and its time (CUDA events,
    under the profiler), pairs/s, host issue time, kernel time (busy share),
    host → device bytes (those the data path hands to ``to_device``) in the
    copies the profiler recorded, and peak device memory."""
    for r, e, st in zip(records, log, stats["chip_smoke.epoch"]):
        gates = "+".join(g for g, k in (("cls", "train_loss"), ("ssl", "ssl_loss"),
                                        ("cm", "cm_loss")) if k in r)
        print(f"  {label} epoch {r['epoch']} ({gates}, {e['transport']}, {e['steps']} steps): "
              f"losses {[round(r[k], 5) for k in ('train_loss', 'ssl_loss', 'cm_loss') if k in r]}"
              f", val AUSum {r['val_ausum']:.4f}; {e['ms']:.1f} ms (CUDA events, profiled), "
              f"{e['steps'] * batch_size / e['ms'] * 1e3:.1f} pairs/s, host issue "
              f"{e['issue_ms']:.1f} ms, kernel time {st['kernel_ms']:.1f} ms "
              f"({st['kernel_ms'] / e['ms']:.1%} busy), host->device {e['h2d_issued']} bytes "
              f"in {st['h2d_copies']} copies, peak {e['peak_gib']:.2f} GiB", flush=True)


def same_as_gather(epochs, test, best) -> None:
    """Run (b) repeats phase 11's fit (the same data, embeddings, weights,
    recipe and batch order) over the host pipeline in place of the
    device-resident dataset: its batches are bit-identical and the steps take
    the generator's draws in one order, so each epoch's losses, CM weight,
    margin and validation metrics, and with the same best epoch the test
    metrics, must equal phase 11's exactly."""
    keys = ("train_loss", "ssl_loss", "cm_loss", "cm_weight", "margin", "val_auroc",
            "val_auprc", "val_ausum", "val_loss")
    ref = {r["epoch"]: r for r in FIT_RESULT["epochs"]}
    differ = [(r["epoch"], k, r[k], ref[r["epoch"]][k]) for r in epochs for k in keys
              if k in r and r[k] != ref[r["epoch"]].get(k)]
    if best == FIT_RESULT["best_epoch"]:
        differ += [(k, test[f"test_{k}"], v) for k, v in FIT_RESULT["test"].items()
                   if test[f"test_{k}"] != v]
    print(f"  b against phase 11's fit over the device-resident dataset: epochs "
          f"{[r['epoch'] for r in epochs]}{' and the test metrics' if best == FIT_RESULT['best_epoch'] else ''}"
          f", {len(differ)} values differ {differ[:4]}", flush=True)
    if differ:
        fail("phase 12 b: the host pipeline's fit differs from the gather fit of phase 11")


def cli_checks(torch, attention, gcn):
    """Phase 12: the training CLI in process, in the JAX CLI's three
    transports, and --eval-only → the launches of its runs."""
    import tempfile

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.dataset import DTIDataset

    os.environ["DRUGLAMP_PACKED_GCN"] = "1"
    cfg = Config()
    total = {}
    with tempfile.TemporaryDirectory() as root:
        write_dataset(root)
        kw = dict(max_nodes=cfg.drug.max_nodes, max_prot_resis=cfg.protein.max_resis,
                  seq_len=cfg.protein.seq_len)
        train = DTIDataset(root, "synthetic", "random", "train.csv", **kw)
        S = len(train) // cfg.solver.batch_size
        n_eval = -(-VAL_PAIRS // cfg.solver.eval_batch_size)
        seed_cache(os.path.join(root, "b", "embed_cache"), train.table, cfg)
        recipe, wollm = cli_yaml(root, "DrugLAMP2C2P", FIT_EPOCHS), cli_yaml(root, "DrugLAMPwoLLM", 1)

        def argv(model, yaml_path, work, *extra):
            return ["--model", model, "--data", "synthetic", "--split", "random",
                    "--data-root", root, "--config", yaml_path, "--work-dir",
                    os.path.join(root, work), "--seed", str(SEED), "--no-comet", *extra]

        runs = {
            "a": ("(a) DrugLAMP2C2P, no cache: the host pipeline with zero bf16 LLM arrays",
                  argv("DrugLAMP2C2P", recipe, "a")),
            "b": ("(b) DrugLAMP2C2P, a seeded cache, --device-data off: the host pipeline over "
                  "the ordinal store", argv("DrugLAMP2C2P", recipe, "b", "--device-data", "off")),
            "c": ("(c) DrugLAMPwoLLM, 1 epoch, --device-data auto: the device-resident dataset",
                  argv("DrugLAMPwoLLM", wollm, "c", "--device-data", "auto")),
        }
        out = {}
        for key, (label, args) in runs.items():
            print(f"  {label}", flush=True)
            rc, log, launches, stats = cli_run(torch, attention, gcn, key, args, root)
            if rc != 0:
                fail(f"phase 12 {key}: the CLI returned {rc}")
            with open(os.path.join(root, key, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            hp = records[0]
            epochs = [r for r in records if "train_loss" in r]
            test = next(r for r in records if "test_auroc" in r)
            want_transport = {"a": "host", "b": "host", "c": "gather"}[key]
            if [e["transport"] for e in log] != [want_transport] * len(epochs):
                fail(f"phase 12 {key}: epochs ran {[e['transport'] for e in log]}, expected "
                     f"{want_transport}")
            if hp["device_data"] != (key == "c"):
                fail(f"phase 12 {key}: device_data {hp['device_data']}")
            gates = [("ssl_loss" in r, "cm_loss" in r) for r in epochs]
            expected = ([(False, False), (True, True), (False, True)] if key != "c"
                        else [(False, False)])
            if not epochs or gates != expected[:len(epochs)]:
                fail(f"phase 12 {key}: the epochs' gates {gates}, expected {expected}")
            print_epochs(key, epochs, log, stats, cfg.solver.batch_size)
            CLI_EPOCHS[key] = [(r["epoch"], e["transport"], e["ms"]) for r, e in zip(epochs, log)]
            check_host_loops(key, stats)
            values = [r[k] for r in epochs for k in ("train_loss", "ssl_loss", "cm_loss",
                                                       "val_ausum") if k in r]
            values += [test[k] for k in ("test_auroc", "test_auprc", "test_loss")]
            if not all(math.isfinite(v) for v in values):
                fail(f"phase 12 {key}: non-finite losses or metrics {values}")
            want = want_launches(gates, S, n_eval)
            if launches != want:
                fail(f"phase 12 {key}: launches {launches}, expected {want}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            best = next(r for r in records if r.get("event") == "done")["best_epoch"]
            print(f"  {key}: test AUROC {test['test_auroc']:.4f}, AUPRC {test['test_auprc']:.4f}"
                  f", loss {test['test_loss']:.5f} (best epoch {best})", flush=True)
            if key == "b":
                same_as_gather(epochs, test, best)
            out[key] = test

        print("  (d) --eval-only on (a)'s ckpt_best.pt, --allow-zero-embeddings", flush=True)
        ckpt = os.path.join(root, "a", "ckpt_best.pt")
        rc, log, launches, stats = cli_run(
            torch, attention, gcn, "d",
            argv("DrugLAMP2C2P", recipe, "a", "--eval-only", "--ckpt", ckpt,
                 "--allow-zero-embeddings"), root)
        if rc != 0:
            fail(f"phase 12 d: the CLI returned {rc}")
        (rec_dir,) = os.listdir(os.path.join(root, "results"))
        with open(os.path.join(root, "results", rec_dir, "metrics.jsonl")) as f:
            record = [json.loads(line) for line in f][1]
        want = {k: round(v, 5) for k, v in out["a"].items() if k.startswith("test_")}
        print(f"  d: {record}; (a)'s test metrics {want}", flush=True)
        if record != want:
            fail("phase 12 d: --eval-only does not reproduce (a)'s test metrics")
        check_host_loops("d", stats)
        want_d = {k: v * n_eval for k, v in CLI_PER_EVAL_BATCH.items()}
        if {k: v for k, v in launches.items() if v} != want_d:
            fail(f"phase 12 d: launches {launches}, expected {want_d}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


# --- phase 13: the frozen encoders ------------------------------------------------------------

ESM_ATOL, CB_ATOL = 1e-4, 2e-5     # card against CPU: 30 layers of reductions in another order
ENCODER_BATCH = 8                  # generate_embeddings' default batch


def encoder_flops(cfg, B: int, L: int) -> float:
    """Operations of an ESM-2 forward over (B, L) tokens: the projections and
    FFN (2·(4E² + 2EF) a token a layer) and the attention products (4·L·E a
    token a layer)."""
    E, F, n = cfg.embed_dim, cfg.ffn, cfg.num_layers
    return 2.0 * B * L * n * (4 * E * E + 2 * E * F) + 4.0 * B * n * L * L * E


def encoder_forward(torch, model, toks, device):
    """``model`` on ``toks`` (numpy) on ``device``, f32 in true f32 under
    inference mode → a CPU tensor."""
    from druglamp_tpu_torch.utils.numerics import true_f32

    with torch.inference_mode(), true_f32():
        return model(torch.from_numpy(toks).to(device)).float().cpu()


def max_row_err(a, b, lens) -> float:
    return max((a[r, :n] - b[r, :n]).abs().max().item() for r, n in enumerate(lens))


def encoder_module_checks(torch, table):
    """Phase 13 (a): ESM-2 t30 and ChemBERTa-77M-MTR with seeded weights
    (``seeded_state``, drawn on the CPU) on the card against the same
    modules on the CPU, f32.  ESM-2 on the embedding pipeline's batch that
    holds the 1022-residue protein (8 × 1032), ChemBERTa on every drug in
    the pipeline's batches (8 × 520) with the regex tokenizer grown from the
    table, as the CLI's random init builds them.  → (the ESM state, {protein
    ordinal: CPU row}, {drug ordinal: CPU row})."""
    from druglamp_tpu_torch.chem.tokenizer import SmilesTokenizer
    from druglamp_tpu_torch.encoders import embed_pipeline as ep
    from druglamp_tpu_torch.encoders.chemberta import ChemBERTa, ChemBERTaConfig
    from druglamp_tpu_torch.encoders.esm2 import (ESM2, ESM_PAD, esm2_config_for_layers,
                                                  esm_tokenize)
    from druglamp_tpu_torch.encoders.layers import seeded_state
    from druglamp_tpu_torch.utils.numerics import true_f32

    cfg = esm2_config_for_layers(30)
    cpu = ESM2(cfg).eval()
    state = seeded_state(cpu, SEED)
    cpu.load_state_dict(state)
    with torch.device(DEVICE):
        card = ESM2(cfg).eval()
    card.load_state_dict(state)
    import numpy as np

    longest = table.prot2ord[max(table.prot2ord, key=len)]
    todo = [(o, esm_tokenize(seq, 1022)) for seq, o in table.prot2ord.items()]
    ords, toks, lens = next(b for b in ep._batched(todo, ENCODER_BATCH, ESM_PAD)
                            if longest in b[0])
    t0 = time.perf_counter()
    ref = encoder_forward(torch, cpu, toks, "cpu")
    cpu_s = time.perf_counter() - t0
    got = [encoder_forward(torch, card, toks, DEVICE) for _ in range(2)]
    i = ords.index(longest)
    alone = encoder_forward(torch, card, toks[i:i + 1, :lens[i]], DEVICE)
    err = max_row_err(got[0], ref, lens)
    alone_err = (alone[0] - got[0][i, :lens[i]]).abs().max().item()
    same = torch.equal(got[0], got[1])
    with torch.inference_mode(), true_f32():
        dev_toks = torch.from_numpy(toks).to(DEVICE)
        ms = time_ms(torch, lambda: card(dev_toks), iters=3, reps=3, warmup=1)
    flops = encoder_flops(cfg, *toks.shape)
    print(f"  (a) ESM-2 t30 ({cfg.num_layers} layers, {cfg.embed_dim} wide, {cfg.num_heads} heads, "
          f"FFN {cfg.ffn}), f32, the batch of ordinals {ords} {tuple(toks.shape)} (real lengths "
          f"{lens}): card vs CPU max |err| {err:.3e} (tolerance {ESM_ATOL:g}); two card runs "
          f"bit-identical {same}; protein {longest} alone ({lens[i]} tokens) vs its row "
          f"{alone_err:.3e}; card {ms:.2f} ms a batch (CUDA events, true f32), "
          f"{flops / 1e12:.3f} TFLOP, {flops / ms / 1e9:.1f} TFLOP/s, bound "
          f"{flops / PEAK_FLOPS['float32'] * 1e3:.2f} ms (f32, operations); CPU {cpu_s:.1f} s",
          flush=True)
    if not same:
        fail("phase 13 a: two card runs of ESM-2 differ")
    if not (err <= ESM_ATOL and alone_err <= ESM_ATOL):
        fail(f"phase 13 a: ESM-2 card vs CPU {err:.3e}, alone vs batch {alone_err:.3e} "
             f"> {ESM_ATOL:g}")
    prot_ref = {o: ref[r, :n] for r, (o, n) in enumerate(zip(ords, lens))}
    del cpu, card, got, dev_toks

    tok = SmilesTokenizer()
    tok.extend_from_corpus(table.drug2ord)
    cb_cfg = ChemBERTaConfig(vocab=max(ChemBERTaConfig().vocab, tok.vocab_size))
    cpu = ChemBERTa(cb_cfg).eval()
    cpu.load_state_dict(seeded_state(cpu, SEED + 1, dense_std=ep.CHEMBERTA_DENSE_STD))
    with torch.device(DEVICE):
        card = ChemBERTa(cb_cfg).eval()
    card.load_state_dict(cpu.state_dict())
    todo = [(o, np.asarray(tok.encode(smi, max_length=512), np.int32))
            for smi, o in table.drug2ord.items()]
    drug_ref, err, same, n_batches = {}, 0.0, True, 0
    for ords, toks, lens in ep._batched(todo, ENCODER_BATCH, cb_cfg.pad_id, ep._DRUG_BUCKETS):
        ref = encoder_forward(torch, cpu, toks, "cpu")
        got = [encoder_forward(torch, card, toks, DEVICE) for _ in range(2)]
        err, same = max(err, max_row_err(got[0], ref, lens)), same and torch.equal(*got)
        drug_ref.update({o: ref[r, :n] for r, (o, n) in enumerate(zip(ords, lens))})
        n_batches += 1
    print(f"  (a) ChemBERTa-77M-MTR ({cb_cfg.num_layers} layers, {cb_cfg.hidden} wide, "
          f"{cb_cfg.num_heads} heads, intermediate {cb_cfg.intermediate}, vocab {cb_cfg.vocab}), "
          f"f32, {len(todo)} drugs in {n_batches} batches of {ENCODER_BATCH} x "
          f"{ep._DRUG_BUCKETS[0]}: card vs CPU max |err| {err:.3e} (tolerance {CB_ATOL:g}); "
          f"two card runs bit-identical {same}", flush=True)
    if not same:
        fail("phase 13 a: two card runs of ChemBERTa differ")
    if not err <= CB_ATOL:
        fail(f"phase 13 a: ChemBERTa card vs CPU {err:.3e} > {CB_ATOL:g}")
    del cpu, card
    torch.cuda.empty_cache()
    return state, prot_ref, drug_ref


@contextlib.contextmanager
def encoder_stages(torch, log):
    """Each encoder stage of ``generate_embeddings`` (``embed_pipeline._encode``)
    inside a ``chip_smoke.embed.<stage>`` range, timed from a synchronised
    start to a synchronised end, with its entity count, real tokens and the
    padded slots of its batches."""
    from druglamp_tpu_torch.encoders import embed_pipeline as ep

    real = ep._encode

    def timed(model, todo, batch, pad_id, buckets, dev, put, what, verbose, every):
        slots = sum(t.size for _, t, _ in ep._batched(todo, batch, pad_id, buckets))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"chip_smoke.embed.{what}"):
            real(model, todo, batch, pad_id, buckets, dev, put, what, verbose, every)
        torch.cuda.synchronize()
        log.append({"stage": what, "s": time.perf_counter() - t0, "n": len(todo),
                    "tokens": sum(len(ids) for _, ids in todo), "slots": slots})

    ep._encode = timed
    try:
        yield
    finally:
        ep._encode = real


def print_stages(label, stages, stats=None) -> None:
    for st in stages:
        line = (f"  {label} {st['stage']} stage: {st['n']} entities in {st['s']:.3f} s, "
                f"{st['n'] / st['s']:.1f} entities/s, {st['tokens']} real tokens "
                f"({st['tokens'] / st['s']:.0f} tokens/s), padding share "
                f"{1 - st['tokens'] / max(st['slots'], 1):.1%} of {st['slots']} slots")
        if stats is not None:
            (k,) = stats[f"chip_smoke.embed.{st['stage']}"] or [{"kernel_ms": 0.0}]
            busy = k["kernel_ms"] / st["s"] / 1e3
            line += f"; kernel time {k['kernel_ms']:.1f} ms ({busy:.1%} busy)"
        print(line, flush=True)


def encoder_checks(torch, attention, gcn, smi):
    """Phase 13: (a) the encoders on the card against the CPU; (b) the CLI's
    --gen-embed-only from an ESM-2 t30 checkpoint in HF naming written here
    from (a)'s seeded weights (ChemBERTa: random init with the regex
    tokenizer), then --gen-embed training on those caches; (c) the times →
    the launches of (b)'s training run."""
    import tempfile

    import numpy as np

    from druglamp_tpu_torch.cli import main as cli
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.cache import EmbeddingCache
    from druglamp_tpu_torch.data.dataset import DTIDataset
    from druglamp_tpu_torch.encoders import embed_pipeline as ep
    from druglamp_tpu_torch.encoders.convert import esm2_names
    from druglamp_tpu_torch.encoders.esm2 import esm2_config_for_layers

    cfg = Config()
    with tempfile.TemporaryDirectory() as root:
        write_dataset(root)
        kw = dict(max_nodes=cfg.drug.max_nodes, max_prot_resis=cfg.protein.max_resis,
                  seq_len=cfg.protein.seq_len)
        train = DTIDataset(root, "synthetic", "random", "train.csv", **kw)
        table = train.table
        print(f"  phase 9's dataset: {table.n_drug} drugs, {table.n_prot} proteins of "
              f"{min(map(len, table.prot2ord))}-{max(map(len, table.prot2ord))} residues",
              flush=True)
        state, prot_ref, drug_ref = encoder_module_checks(torch, table)

        ckpt = os.path.join(root, "esm2_t30.pt")
        names = esm2_names(esm2_config_for_layers(30).num_layers)
        torch.save({hf: state[key] for key, (hf, _) in names.items()}, ckpt)
        del state
        recipe = cli_yaml(root, "DrugLAMP2C2P", FIT_EPOCHS)
        work = os.path.join(root, "e")
        argv = ["--model", "DrugLAMP2C2P", "--data", "synthetic", "--split", "random",
                "--data-root", root, "--config", recipe, "--work-dir", work, "--seed", str(SEED),
                "--no-comet", "--n-layer", "30", "--esm-ckpt", ckpt]

        print("  (b1) --gen-embed-only --esm-ckpt esm2_t30.pt (HF naming), ChemBERTa random "
              "init with the regex tokenizer", flush=True)
        stages = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with encoder_stages(torch, stages):
            rc = cli.main(argv + ["--gen-embed-only"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if rc != 0:
            fail(f"phase 13 b1: the CLI returned {rc}")
        cache = EmbeddingCache(os.path.join(work, "embed_cache"), "synthetic", 384, 640)
        missing = ([o for o in range(table.n_prot) if not cache.has_prot(o)]
                   + [o for o in range(table.n_drug) if not cache.has_drug(o)])
        bad_shape = [o for seq, o in table.prot2ord.items()
                     if cache.prot(o).shape != (min(len(seq), 1022) + 2, 640)]
        bad_shape += [o for o in range(table.n_drug) if cache.drug(o).shape[1] != 384
                      or cache.drug(o).shape[0] != drug_ref[o].shape[0]]
        finite = all(np.isfinite(cache.prot(o)).all() for o in range(table.n_prot)) and all(
            np.isfinite(cache.drug(o)).all() for o in range(table.n_drug))
        p_err = max((torch.from_numpy(cache.prot(o)) - r).abs().max().item()
                    for o, r in prot_ref.items())
        d_err = max((torch.from_numpy(cache.drug(o)) - r).abs().max().item()
                    for o, r in drug_ref.items())
        with open(os.path.join(work, "30_layers_params.txt")) as f:
            sidecar = f.read()
        print(f"  b1: rc {rc} in {wall:.1f} s, peak {peak:.2f} GiB; {table.n_prot} protein and "
              f"{table.n_drug} drug caches, missing {missing}, wrong shapes {bad_shape}, all "
              f"finite {finite}; the cached rows of (a)'s ESM batch vs (a)'s CPU forward "
              f"{p_err:.3e} (tolerance {ESM_ATOL:g}), every drug's vs (a)'s CPU forward "
              f"{d_err:.3e} (tolerance {CB_ATOL:g}); sidecar {sidecar!r}", flush=True)
        print_stages("b1", stages)
        if missing or bad_shape or not finite:
            fail("phase 13 b1: the caches are incomplete, misshapen or not finite")
        if not (p_err <= ESM_ATOL and d_err <= CB_ATOL):
            fail(f"phase 13 b1: caches vs (a)'s CPU forwards {p_err:.3e} / {d_err:.3e}")
        if sidecar != "384\t640\n":
            fail(f"phase 13 b1: sidecar {sidecar!r}")

        prof_stages = []
        again = EmbeddingCache(os.path.join(root, "again"), "synthetic", 384, 640)
        with encoder_stages(torch, prof_stages), profiling(torch, cpu=True) as prof:
            ep.generate_embeddings(table, again, n_layer=30, esm_ckpt=ckpt, verbose=False,
                                   device=DEVICE)
        stats = span_stats(torch, prof, tuple(f"chip_smoke.embed.{s['stage']}"
                                              for s in prof_stages), ())
        print("  the same generation again, profiled:", flush=True)
        print_stages("profiled", prof_stages, stats)
        differ = [o for o in range(table.n_prot)
                  if not np.array_equal(again.prot(o), cache.prot(o))]
        differ += [o for o in range(table.n_drug)
                   if not np.array_equal(again.drug(o), cache.drug(o))]
        print(f"  profiled run's caches against b1's: {len(differ)} entities differ", flush=True)
        if differ:
            fail(f"phase 13: a second generation differs for ordinals {differ[:5]}")

        print("  (b2) --gen-embed on the same work dir, the recipe cut to 3 epochs", flush=True)
        stages = []
        with encoder_stages(torch, stages):
            rc, log, launches, stats = cli_run(torch, attention, gcn, "b2", argv + ["--gen-embed"],
                                               root)
        if rc != 0:
            fail(f"phase 13 b2: the CLI returned {rc}")
        if any(st["n"] for st in stages):
            fail(f"phase 13 b2: generated {[(st['stage'], st['n']) for st in stages]}, "
                 f"expected nothing")
        with open(os.path.join(work, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        epochs = [r for r in records if "train_loss" in r]
        test = next(r for r in records if "test_auroc" in r)
        gates = [("ssl_loss" in r, "cm_loss" in r) for r in epochs]
        expected = [(False, False), (True, True), (False, True)]
        if not epochs or gates != expected[:len(epochs)]:
            fail(f"phase 13 b2: the epochs' gates {gates}")
        if ([e["transport"] for e in log] != ["gather"] * len(epochs)
                or not records[0]["device_data"]):
            fail(f"phase 13 b2: epochs ran {[e['transport'] for e in log]}, expected gather")
        print_epochs("b2", epochs, log, stats, cfg.solver.batch_size)
        for r in epochs:
            beside = [(k, t, ms) for k, runs in CLI_EPOCHS.items() for e, t, ms in runs
                      if e == r["epoch"]]
            print(f"  b2 epoch {r['epoch']} beside phase 12's (run, transport, ms by CUDA events "
                  f"under the profiler): {beside}", flush=True)
        check_host_loops("b2", stats)
        values = [r[k] for r in epochs for k in ("train_loss", "ssl_loss", "cm_loss", "val_ausum")
                  if k in r] + [test[k] for k in ("test_auroc", "test_auprc", "test_loss")]
        if not all(math.isfinite(v) for v in values):
            fail(f"phase 13 b2: non-finite losses or metrics {values}")
        S = len(train) // cfg.solver.batch_size
        want = want_launches(gates, S, -(-VAL_PAIRS // cfg.solver.eval_batch_size))
        if launches != want:
            fail(f"phase 13 b2: launches {launches}, expected {want}")
        print(f"  b2: test AUROC {test['test_auroc']:.4f}, AUPRC {test['test_auprc']:.4f}, "
              f"loss {test['test_loss']:.5f}; (c) card: {smi}", flush=True)
    return launches


@contextlib.contextmanager
def profiling(torch, cpu: bool = False):
    """A profiler window (the card's activity, and the host's with ``cpu``)
    that opens with a lead-in ``spin_kernel`` of some 20 ms and stays open
    PROFILE_SETTLE_S after the card has finished its last kernel.  Late in a
    long run the profiler loses records at both ends of a window: with no
    wait at the end, those of its last few hundred microseconds; at the
    start, a kernel's first launch in the window and at times a few more.
    The block's kernels queue behind the lead-in; ``device_kernels`` leaves
    the lead-in's own record out."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
        torch.cuda._sleep(LEAD_IN_CYCLES)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)


def launch_delta(torch, counters, fn) -> int:
    """The launches one call of ``fn`` adds to a wrapper's ``LAUNCHES``."""
    before = sum(counters.values())
    fn()
    torch.cuda.synchronize()
    return sum(counters.values()) - before


def device_ms(torch, fn, own=None, iters: int = 50, warmup: int = 3, tries: int = 8) -> float:
    """Device time per call of ``fn``: the profiler's kernel time over
    ``iters`` back-to-back calls.  For calls whose kernels take less time
    than the host needs to issue them, CUDA events around a loop measure the
    host; the kernels' own device time is what the profiler reads.

    Late in a long run the profiler loses the record of a kernel's first
    launch in a window (every window, from phase 7 on).  So each window
    opens with one unmeasured call of ``fn`` and a short marker
    ``spin_kernel``, and only the records that start after the marker are
    read.  A window counts only if it holds every record it should:
    ``iters`` times the records of one call, counted in a one-call window
    just before it, and, for the port's kernels, ``own`` {name part: records
    per call} from the wrapper's ``LAUNCHES`` (``launch_delta``) in both
    windows.  A window that does not is profiled again, up to ``tries``
    times, and then the phase fails: no time is scaled, guessed or returned
    as 0."""
    own = own or {}
    device = torch.autograd.DeviceType.CUDA

    def profiled(calls):
        with profiling(torch) as prof:
            fn()
            torch.cuda._sleep(MARKER_CYCLES)
            for _ in range(calls):
                fn()
        events = list(prof.events())
        cpu_names = {e.name for e in events if e.device_type != device}
        ran = [e for e in events if e.device_type == device and e.name not in cpu_names
               and not getattr(e, "is_user_annotation", False)]
        marks = [e.time_range.end for e in ran if "spin_kernel" in e.name]
        after = max(marks) if marks else math.inf
        kernels = [e for e in ran if "spin_kernel" not in e.name and e.time_range.start >= after]
        counts = {}
        for e in kernels:
            counts[e.name] = counts.get(e.name, 0) + 1
        return sum(e.time_range.elapsed_us() for e in kernels), counts

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    gc.collect()                      # no earlier profiler's results left alive
    for attempt in range(tries):
        _, one = profiled(1)
        total, window = profiled(iters)
        per_call, count = sum(one.values()), sum(window.values())
        own_one = {n: sum(c for k, c in one.items() if n in k) for n in own}
        own_n = {n: sum(c for k, c in window.items() if n in k) for n in own}
        if (per_call and count == iters * per_call and own_one == own
                and own_n == {n: iters * k for n, k in own.items()}):
            return total / iters / 1e3
        PROFILE_RETRIES.append((per_call, count))
        short = sorted(((iters * one.get(k, 0) - window.get(k, 0), k[:60])
                        for k in set(one) | set(window)), reverse=True)[:3]
        print(f"  (device_ms, try {attempt + 1}: {count} kernel records for {iters} calls, one "
              f"call {per_call}; the port's kernels {own_n} for {own_one} a call, expected "
              f"{own}; fewest against one call: {short}; profiled again)", flush=True)
    fail(f"device_ms: the profiler did not return every kernel record in {tries} tries")


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
        own = {"kernel": {"gcn_packed_kernel": launch_delta(torch, gcn.LAUNCHES, kernel)},
               "library": None}
        times = {"kernel": [], "library": []}
        for label, fn in turns:
            times[label].append(device_ms(torch, fn, own[label]))
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
    from druglamp_tpu_torch.config import Config

    tf32_checks(torch, F, Config())
    f32_determinism(torch, Config())

    phase("7 training timing")
    print(f"  card: {smi}", flush=True)
    # the kernel timings first: after the profiled step and epoch, later profiler
    # windows lose kernel records (PERF.md, section 6)
    records += [bwd_kernel_record(torch, F, attention, "paired_attention_bwd", True,
                                  train_launches, train_err["paired_attention_bwd"]),
                bwd_kernel_record(torch, F, attention, "self_attention_bwd", False,
                                  train_launches, train_err["self_attention_bwd"])]
    train_timing(torch, attention, model, state, step, batch)
    del model, state, step, batch

    phase("8 packed GCN kernel vs plain")
    from druglamp_tpu_torch.kernels import gcn

    gcn_err = gcn_checks(torch, gcn)

    phase("9 device-resident training epoch")
    print(f"  card: {smi}", flush=True)
    import tempfile

    cfg = Config()
    with tempfile.TemporaryDirectory() as root:
        train, val, test, data, emb = build_epoch_data(cfg, root)
    state, epoch, plan, epoch_launches = epoch_checks(torch, attention, gcn, cfg, train, val,
                                                      data, emb)
    records.append(gcn_record(torch, gcn, plan[2], epoch_launches, gcn_err))
    epoch_timing(torch, state, epoch, plan, emb)
    del state, epoch, plan

    phase("10 full-gate training step (DrugLAMP2C2P)")
    print(f"  card: {smi}", flush=True)
    gate_launches = full_gate_checks(torch, attention, gcn)

    phase("11 Trainer.fit (the DrugLAMP2C2P recipe)")
    print(f"  card: {smi}", flush=True)
    fit_launches = fit_checks(torch, attention, gcn, train, val, test, data, emb)
    del train, val, test, data, emb

    phase("12 the training CLI (druglamp_tpu_torch.cli.main)")
    print(f"  card: {smi}", flush=True)
    cli_launches = cli_checks(torch, attention, gcn)

    phase("13 the frozen encoders (ESM-2, ChemBERTa, --gen-embed)")
    print(f"  card: {smi}", flush=True)
    enc_launches = encoder_checks(torch, attention, gcn, smi)
    for rec in records:        # the launches of the main path, phases 10 to 13 included
        keys = ([rec["name"]] if rec["name"] != "gcn_packed_matmul"
                else ["gcn_packed_matmul", "gcn_packed_matmul_bwd"])
        rec["launches"] += sum(gate_launches[k] + fit_launches[k] + cli_launches.get(k, 0)
                               + enc_launches.get(k, 0) for k in keys)
    print(f"  device_ms: {len(PROFILE_RETRIES)} timing windows profiled again", flush=True)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
