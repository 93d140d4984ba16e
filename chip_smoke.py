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
   calls beside them (its kernels' names show the backend SDPA picked); then
   each attention kernel, forward and backward, at phase 15's model-rank
   shape (B=16, H=2) by device time beside its plain version and its bound.
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

14. data parallel — two ranks of this script (``--dp-rank``, started with
   torchrun's variables): one a card over NCCL with two cards or more, else
   both on cuda:0 over gloo (printed; a failure is never retried another
   way).  (a) DrugLAMP2C2P's full-gate step at ``Config()`` in f32, dropout
   0, the fixed MLM mask of the parity tests, the batch of 16 split in
   halves: global mode against the one-process step on the 16 rows,
   per_replica against the one-process ``bn_groups=2`` step (losses 1e-5,
   gradients rtol 5e-3 / atol 5e-5), then one step over the ranks after
   which both hold the same parameters and buffers bit for bit; (b) 10 bf16
   full-gate steps: each rank's launches by phase 10's one-process formula,
   the step by CUDA events, host issue time, the collectives' time and
   share of a profiled step (table per rank in
   ``chiprun_out/dp_profile_rank<r>.txt``); two ranks on one card measure
   correctness and the collectives' cost, not scaling; (c) phase 12's
   3-epoch DrugLAMP2C2P recipe through ``cli.main`` on both ranks, gather
   transport, global mode: finite metrics identical on both ranks,
   checkpoints written by rank 0 only, the launches by phase 12's formula,
   and the run resumed from its epoch-1 checkpoints ending with the same
   ``ckpt_last.pt`` bit for bit.

15. model axis — (a) every attention kernel, forward and backward, at a
   model rank's heads (H = 2 and 1 of 4: --mesh-model 2 and 4) at B = 16 and
   32, f32 and bf16, against its plain version at phase 3's tolerances (each
   in bf16 at B = 16, H = 2 is timed in phase 7, in two profiler windows and
   by CUDA events over calls queued behind a spin kernel, beside its plain
   version and its bound: the kernel records' ``tp_*`` keys); then two ranks of this
   script (``--tp-rank``) as one model axis (``--mesh-model 2``, n_data 1),
   placed as phase 14's: (b) DrugLAMP2C2P's full-gate step at ``Config()``
   in f32, dropout 0.1 from one generator seed, the fixed MLM mask, tensor
   parallel (``build_model(mesh=)``: Megatron PMMA and MLP head), its
   gradients gathered against the one-process step (losses 1e-5, gradients
   rtol 5e-3 / atol 5e-5, the leaves outside counted), then one step in
   each grad mode: the replicated leaves bit-identical on both ranks, the
   gradient each AdamW applied (its first moment, gathered) within the
   gradient tolerance of the one-process step's, the gathered parameters
   within AdamW's first-step reach of it; (c) 10 bf16
   full-gate steps over the model axis: each rank's launches by phase 10's
   formula, every attention launch at 2 heads, the step by CUDA events, host
   issue time, the collectives' count, time and share, the GEMM kernels by
   name (tables in ``chiprun_out/tp_profile_rank<r>.txt``), the row-parallel
   products of a step timed as run (bf16 GEMMs with an f32 result) and as
   f32 GEMMs of widened operands, the losses against 10
   one-process bf16 steps; (d) phase 12's 3-epoch DrugLAMP2C2P recipe
   through ``cli.main`` with ``--mesh-model 2`` (the gather transport, a
   seeded cache): metrics identical on both ranks, checkpoints from rank 0
   only, launches by phase 12's formula, and the records equal to a
   one-process run of the same flags value for value (host-clock keys left
   out); (e) ``--gen-embed-only --mesh-model 2`` on 6 proteins and 6 drugs,
   ESM-2 t30 column-parallel from its seeded random init: the caches within
   phase 13's tolerances of a one-process run's.

16. leftovers — (a) DrugLAMPwoLLM with ``pmma_variant="linattn"`` at
   ``Config()``: one bf16 cls step (finite; 4 paired forward and backward
   launches, no self attention), and in f32, dropout 0, the step through the
   kernels against the plain attention (loss 1e-5, gradients rtol 5e-3 /
   atol 5e-5); (b) ``Trainer.fast_dev_run`` on phase 9's data, DrugLAMP2C2P
   with ssl and cm on: 4 training batches over the host pipeline and the
   validation pass, finite losses, the launches of its steps and eval
   batches, nothing written.

17. switches — at ``Config()``, batch 16: (a) 20 f32 cls steps of DrugLAMP with the
   per-leaf AdamW, each step's gradient also given to a ``FlatAdamW`` over a
   copy of the starting parameters: within rtol 1e-5 / atol 1e-7 after the
   steps; then one bf16 full-gate step (ssl, cm, calibrate) of DrugLAMP2C2P,
   packed GCN, with the per-leaf and with the flat optimizers
   (``TrainState.create(flat_opt=)``) from one seed and one set of weights:
   equal losses, parameters within rtol 1e-5 / atol 1e-7, each
   kernel's launches, the step by CUDA events, its peak memory and its
   kernel launches (profiled); (b) the 3-epoch recipe fit (phase 11's, on
   128 training pairs and 64 validation and test pairs) with asynchronous
   checkpoint writes and with ``DRUGLAMP_SYNC_CKPT=1``: equal files, each
   epoch's wall time, and a resume from the asynchronous epoch-2
   ``ckpt_last.pt`` equal to the unbroken run; (c)
   ``utils.profiling.device_time_ms`` of the paired forward beside phase 5's
   ``device_ms`` (finite and positive), and ``trace()`` writes a non-empty
   trace; (d) the native packer builds, and a dense batch (``compact=False``,
   bf16 LLM arrays, the native adjacency) gives DrugLAMP's bf16 forward of
   the compact batch bit for bit.

18. remat — ``DRUGLAMP_REMAT`` (``train/remat.py``) on DrugLAMP2C2P's
   full-gate step (ssl, cm, calibrate) at ``Config()``, packed GCN, per-leaf
   AdamW, weights from SEED: (a) in f32, dropout as configured, in both grad
   modes, ``dots`` and ``full`` (run under the caller's TF32 settings) give
   ``none``'s losses, probabilities, CM weight, parameters, BatchNorm
   buffers, AdamW moments and generator state bit for bit; (b) the same in
   bf16 at batch 16, with each kernel's launches against the regions'
   count (``REMAT_PER_STEP``: the forward kernels again in each recompute),
   and for each mode one step with the allocator's history on
   (``step_memory``: the bytes when the first gradient starts and at the
   peak, and who holds them, by region; tables in
   ``chiprun_out/remat_memory.txt``) and the step by CUDA events; fails
   unless ``dots`` and ``full`` peak below ``none``; (c) a 4-step gather
   epoch on phase 9's dataset under ``full`` equal to ``none``; (d) the
   peaks at batch 64 under ``none`` and ``full``.

19. AdamW kernel — the multi-tensor AdamW (``kernels/adamw.py``,
   ``csrc/adamw.cu``) over DrugLAMP2C2P's 236 leaves (14,882,888 f32
   entries): 20 steps of seeded gradients against torch's foreach
   capturable AdamW (parameters, moments, step counts within rtol 1e-5 /
   atol 1e-7); one step's device time by CUDA events around calls queued
   behind a spin kernel (``queued_ms``) against its bytes bound (28 B an
   entry), fails above 250 us; the host's time to issue it, and torch's
   foreach step back to back (the host's pace).  Its record joins the
   kernel records, with the main path's launches: phases 6, 9 and 10 count
   the kernel's launches with the others' and fail unless a step launches it
   once an optimizer (1 a cls step, 3 a full-gate step, none in the eval
   pass).  The run's total seconds are printed last.

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
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS's kernel names for a GEMM
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


TRAIN_B = 16                 # the recipe's batch
FWD_CASES = [  # (B, H, L, S, D, paired): serving, training, then ragged shapes that
    # cover the other instantiations; self at B=1 (one tile per block) and L ≠ S
    (32, 4, 256, 256, 64, True), (32, 4, 256, 256, 128, False),
    (TRAIN_B, 4, 256, 256, 64, True), (TRAIN_B, 4, 256, 256, 128, False),
    (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False),
    (1, 4, 256, 256, 128, False), (2, 3, 200, 130, 128, False), (2, 2, 70, 300, 128, False),
]


def kernel_checks(torch, attention, cases=FWD_CASES):
    """Phase 3 (and 15 at a model rank's heads): max |kernel − plain| per
    case; fails outside tolerance → {name: the bf16 error at L=S=256, B=32,
    H=4} and {(name, B, H): its bf16 error at L=S=256}."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    serve_err, errs = {}, {}
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
            if dtype == torch.bfloat16 and (L, S) == (256, 256):
                errs[(name, B, H)] = err
                if (B, H) == (32, 4):
                    serve_err[name] = err
    return serve_err, errs


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


TRAIN_STEPS = 10
TRAIN_LR = 1e-4


BWD_CASES = [(TRAIN_B, 4, 256, 256, 64, True), (TRAIN_B, 4, 256, 256, 128, False),
             (2, 3, 37, 70, 128, True), (3, 2, 100, 33, 64, False), (2, 3, 150, 70, 64, True)]


def backward_checks(torch, attention, cases=BWD_CASES):
    """Phase 3 (and 15 at a model rank's heads), backwards: gradients
    through the autograd Functions (forward and backward kernels) against
    the plain backward; fails outside tolerance.  Returns max |err| per
    kernel at the bf16 training shapes (B=TRAIN_B, H=4) and {(name, B, H):
    max |err| at L=S=256}."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    train_err, errs_at = {}, {}
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
            if dtype == torch.bfloat16 and (L, S) == (256, 256):
                errs_at[(name, B, H)] = max(errs)
                if (B, H) == (TRAIN_B, 4):
                    train_err[name] = max(errs)
    return train_err, errs_at


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

    from druglamp_tpu_torch.kernels import adamw

    attention.reset_launch_counts()
    adamw.reset_launch_counts()
    losses = [step(state, batch, gen, TRAIN_LR).cls_loss for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = {**attention.LAUNCHES, **adamw.LAUNCHES}
    per_step = {"paired_attention_fwd": 4, "self_attention_fwd": 2,
                "paired_attention_bwd": 4, "self_attention_bwd": 2, "adamw": 1}
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
    from druglamp_tpu_torch.kernels import adamw

    attention.reset_launch_counts()
    gcn.reset_launch_counts()
    adamw.reset_launch_counts()


def epoch_checks(torch, attention, gcn, cfg, train, val, data, emb):
    """Phase 9: one epoch of make_epoch_step_gather (bf16, packed GCN on)
    and the eval pass of make_eval_scan_gather, the main path; then the f32
    agreement of the packed kernel with the plain and the dense GCN.
    Returns (state, epoch fn, plan, launch counts of the main path)."""
    import numpy as np

    from druglamp_tpu_torch.data.device_data import eval_index_plan, train_index_plan
    from druglamp_tpu_torch.eval.metrics import MetricCollector
    from druglamp_tpu_torch.kernels import adamw
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
    launches = {**attention.LAUNCHES, **gcn.LAUNCHES, **adamw.LAUNCHES}
    per_step = {"paired_attention_fwd": 4, "self_attention_fwd": 2, "paired_attention_bwd": 4,
                "self_attention_bwd": 2, "gcn_packed_matmul": 3, "gcn_packed_matmul_bwd": 3,
                "adamw": 1}
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
    eval_launches = {**attention.LAUNCHES, **gcn.LAUNCHES, **adamw.LAUNCHES}
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


def full_gate_batch(torch, cfg, B: int = TRAIN_B):
    """One compact batch of B (default TRAIN_B) from make_batch, with CM ground
    truth from 5 proteins and 7 drugs: proteins 0–3 have positives and
    negatives, protein 4 negatives only (the triplet loss's fallback rows)."""
    import numpy as np

    from druglamp_tpu_torch.data.encoding import compact_batch
    from druglamp_tpu_torch.data.loader import build_cm_arrays
    from druglamp_tpu_torch.utils.synthetic import make_batch

    host = make_batch(cfg, B, seed=SEED, n_drug_feature=384, n_prot_feature=640)
    batch = compact_batch(host, (host["d_fill"] == 0).sum(1))
    t = np.arange(B)
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
    from druglamp_tpu_torch.kernels import adamw

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
    launches = {**attention.LAUNCHES, **gcn.LAUNCHES, **adamw.LAUNCHES}
    per_step = {**FULL_GATE_PER_STEP, "adamw": 3}       # one launch an optimizer
    print(f"  main path: {TRAIN_STEPS} full-gate steps, launches {launches}", flush=True)
    if launches != {k: TRAIN_STEPS * v for k, v in per_step.items()}:
        fail(f"full-gate launches {launches}, expected {per_step} per step")
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
                t._join_ckpt()             # the write done
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


# --- phase 14: data-parallel training over two ranks ---------------------------------------

DP_WORLD = 2
DP_TIMEOUT_S = 480
DP_HALF = TRAIN_B // DP_WORLD
DP_ISSUE_STEPS = 5           # steps whose host issue time (b) reads


def dp_plan(torch):
    """(backend, the ranks' device, what it means): one rank a card over NCCL
    when there are cards enough, else both ranks on cuda:0 over gloo."""
    if torch.cuda.device_count() >= DP_WORLD:
        return "nccl", "cuda", f"one rank a card (cuda:0, cuda:1) over NCCL"
    return ("gloo", "cuda:0", f"both ranks on cuda:0 over gloo ({torch.cuda.device_count()} card: "
            "correctness and the collectives' cost, not scaling)")


def dp_checks(torch, smi):
    """Phase 14: start DP_WORLD ranks of this script (``--dp-rank``, with
    torchrun's variables), each on the plan's card, and check what they
    report → the launches of the main path ((b) and (c)) summed over the
    ranks."""
    import tempfile

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.dataset import DTIDataset

    backend, device, how = dp_plan(torch)
    print(f"  {DP_WORLD} ranks: {how}; card: {smi}", flush=True)
    torch.cuda.empty_cache()
    cfg = Config()
    with tempfile.TemporaryDirectory() as root:
        write_dataset(root)
        train = DTIDataset(root, "synthetic", "random", "train.csv", max_nodes=cfg.drug.max_nodes,
                           max_prot_resis=cfg.protein.max_resis, seq_len=cfg.protein.seq_len)
        seed_cache(os.path.join(root, "c", "embed_cache"), train.table, cfg)
        os.makedirs(os.path.join(root, "r"))
        os.symlink(os.path.join(root, "c", "embed_cache"), os.path.join(root, "r", "embed_cache"))
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump({"backend": backend, "device": device, "root": root,
                       "yaml": cli_yaml(root, "DrugLAMP2C2P", FIT_EPOCHS),
                       "steps": len(train) // cfg.solver.batch_size}, f)
        outs = run_ranks("--dp-rank", root, backend, DP_WORLD, DP_TIMEOUT_S, "phase 14")
    first, second = outs
    # a rank's collectives include its wait for the rank that arrives last
    # (NCCL kernels spin on the card meanwhile), so the least reading is the
    # collectives' own cost
    least = min(outs, key=lambda o: o["b"]["coll_ms"])["b"]
    print(f"  b: collectives {least['coll_ms']:.2f} ms of a {least['step_ms']:.2f} ms step "
          f"({least['coll_ms'] / least['step_ms']:.1%}) on the rank that waited least; the "
          f"ranks' readings {[round(o['b']['coll_ms'], 2) for o in outs]} ms", flush=True)
    if first["c"]["evaluations"] != second["c"]["evaluations"]:
        fail("phase 14 c: the ranks' validation and test metrics differ")
    if second["c"]["saves"] or not first["c"]["saves"]:
        fail(f"phase 14 c: checkpoints written by rank 1 {second['c']['saves']}, by rank 0 "
             f"{first['c']['saves']}")
    print(f"  c: metrics identical on both ranks ({len(first['c']['evaluations'])} evaluations); "
          f"checkpoints from rank 0 only ({len(first['c']['saves'])} writes)", flush=True)
    total = {}
    for out in outs:
        for k, v in out["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def run_ranks(flag: str, root: str, backend: str, world: int, timeout: float, label: str):
    """Start ``world`` ranks of this script (``flag <root>``, torchrun's
    variables), print rank 0's output and the last lines of the others',
    and fail unless all end with 0 → each rank's ``<root>/rank<r>.json``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
           "DRUGLAMP_PACKED_GCN": "1", "DRUGLAMP_DIST_BACKEND": backend}
    logs = [open(os.path.join(root, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, root],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    end = time.time() + timeout
    while any(p.poll() is None for p in procs) and time.time() < end:
        if any(p.returncode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for r, f in enumerate(logs):
        f.seek(0)
        lines = f.read().splitlines()
        f.close()
        for line in (lines if r == 0 or procs[r].returncode else lines[-3:]):
            print(f"  [rank {r}] {line}", flush=True)
    if any(p.returncode != 0 for p in procs):
        fail(f"{label}: ranks returned {[p.returncode for p in procs]} (timeout {timeout} s)")
    outs = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def dp_fixed_mask(seq, generator, **kw):
    """The MLM mask of every 5th non-pad position (the parity tests' own):
    the same tokens whichever rank holds a row."""
    import torch

    idx = torch.arange(seq.shape[1], device=seq.device)[None, :]
    mask = (seq != 0) & (idx % 5 == 0)
    return torch.where(mask, torch.full_like(seq, 26), seq), torch.where(mask, seq, 0), mask


def dp_grouped_cm(torch, labels):
    """full_gate_batch's CM ground truth, one block a rank's half."""
    import numpy as np

    from druglamp_tpu_torch.data.loader import build_cm_arrays

    t = np.arange(TRAIN_B)
    y = labels.cpu().numpy()
    halves = [build_cm_arrays(t[s] % 5, t[s] % 7, y[s])
              for s in (slice(0, DP_HALF), slice(DP_HALF, TRAIN_B))]
    return {k: torch.from_numpy(np.stack([h[k] for h in halves])).to(DEVICE) for k in halves[0]}


def dp_same_on_ranks(torch, mesh, tensors) -> bool:
    """Every rank holds these tensors bit for bit (their bits' maximum and
    minimum over the ranks agree)."""
    import torch.distributed as dist

    bits = torch.cat([t.detach().reshape(-1).float().view(torch.int32) for t in tensors])
    hi, lo = bits.clone(), bits.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


def dp_f32_checks(torch, mesh, rank):
    """(a) The full-gate step in f32, dropout 0, the fixed MLM mask, at full
    width: global mode against the one-process step on the global batch,
    per_replica against the one-process bn_groups=2 step (rank 0 computes
    them); losses 1e-5, gradients rtol 5e-3 / atol 5e-5; then one step over
    the ranks: parameters and buffers bit-identical on both ranks."""
    import dataclasses

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.encoding import decode_batch
    from druglamp_tpu_torch.losses import masking
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train import steps
    from druglamp_tpu_torch.train.state import TrainState

    cfg = Config()
    cfg32 = dataclasses.replace(cfg, pmma_dropout=0.0,
                                solver=dataclasses.replace(cfg.solver, compute_dtype="float32"))
    saved, masking.mlm_mask = masking.mlm_mask, dp_fixed_mask
    batch = full_gate_batch(torch, cfg32)
    one = torch.ones((), device=DEVICE)

    def model_for(groups):
        return build_model("DrugLAMP2C2P", cfg32, generator=torch.Generator().manual_seed(SEED),
                           bn_groups=groups).to(DEVICE).train()

    def grads_of(model, b, m):
        with steps.train_numerics():
            cls, ssl, cm, _, _, g = steps.loss_gradients(model, decode_batch(dict(b)), None, True,
                                                         True, False, MARGIN, one, mesh=m)
        return [float(cls), float(ssl), float(cm)], g

    for mode, groups in (("global", 1), ("per_replica", 2)):
        b = dict(batch)
        if groups > 1:
            b["cm"] = dp_grouped_cm(torch, batch["labels"])
        shard = mesh.shard_batch(b, whole=("cm",) if groups == 1 else ())
        losses, grads = grads_of(model_for(groups), shard, mesh)
        if rank == 0:
            ref_losses, ref = grads_of(model_for(groups), b, None)
            worst, bad = 0.0, []
            for loss in ("cls", "ssl", "cm"):
                for i, (a, r) in enumerate(zip(grads[loss], ref[loss])):
                    worst = max(worst, (a - r).abs().max().item())
                    if not torch.allclose(a, r, rtol=5e-3, atol=5e-5):
                        bad.append((loss, i))
            dloss = max(abs(a - r) for a, r in zip(losses, ref_losses))
            print(f"  a {mode}: f32 full gate over {DP_WORLD} ranks ({DP_HALF} rows each) vs one "
                  f"process on the {TRAIN_B} rows: losses {['%.7f' % x for x in losses]} vs "
                  f"{['%.7f' % x for x in ref_losses]}, max |Δ| {dloss:.3e} (tol 1e-5); 3 × "
                  f"{len(grads['cls'])} gradient leaves, max |Δg| {worst:.3e} (rtol 5e-3, atol "
                  f"5e-5), {len(bad)} outside", flush=True)
            if bad or dloss > 1e-5:
                fail(f"phase 14 a {mode}: the ranks' step differs from one process: {bad[:5]}")
            del ref
        mesh.barrier()
        model = model_for(groups)
        step = steps.make_train_step(model, True, True, calibrate=True, device=DEVICE, mesh=mesh)
        state = TrainState.create(model, True, True)
        step(state, shard, None, F32_LR, SSL_LR, CM_LR, MARGIN, 1.0)
        same = dp_same_on_ranks(torch, mesh, list(model.state_dict().values()))
        print(f"  a {mode}: after one step, {len(model.state_dict())} parameters and buffers "
              f"{'bit-identical' if same else 'DIFFERENT'} on the {DP_WORLD} ranks", flush=True)
        if not same:
            fail(f"phase 14 a {mode}: the ranks' parameters differ after a step")
        del model, step, state, grads
    masking.mlm_mask = saved


def dp_bf16_steps(torch, attention, gcn, mesh, rank, backend):
    """(b) TRAIN_STEPS bf16 full-gate steps over the ranks at full width, the
    global batch of TRAIN_B split in halves: each rank's launches by the
    one-process formula, finite losses; the step by CUDA events, host issue
    time, and from one profiled step the collectives' time and share
    → (launches, {"step_ms", "coll_ms"})."""
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_train_step

    cfg = Config()
    model = build_model("DrugLAMP2C2P", cfg, generator=torch.Generator().manual_seed(SEED))
    step = make_train_step(model, True, True, calibrate=True, device=DEVICE, mesh=mesh)
    state = TrainState.create(model, True, True)
    shard = mesh.shard_batch(full_gate_batch(torch, cfg), whole=("cm",))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + rank)
    w = 1e-3
    reset_counts(attention, gcn)
    outs = []
    for _ in range(TRAIN_STEPS):
        outs.append(step(state, shard, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, w))
        w = outs[-1].cm_weight
    torch.cuda.synchronize()
    launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
    want = {k: TRAIN_STEPS * v for k, v in FULL_GATE_PER_STEP.items()}
    losses = [[float(getattr(o, k)) for o in outs] for k in ("cls_loss", "ssl_loss", "cm_loss")]
    print(f"  b: {TRAIN_STEPS} bf16 full-gate steps, {DP_HALF} rows a rank; launches {launches} "
          f"(one-process formula {want}); cls losses {['%.5f' % x for x in losses[0]]}",
          flush=True)
    if launches != want:
        fail(f"phase 14 b: rank {rank} launches {launches}, expected {want}")
    if not all(math.isfinite(x) for row in losses for x in row):
        fail("phase 14 b: non-finite losses")
    run = lambda: step(state, shard, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, w)   # noqa: E731
    timing = step_collectives(torch, run, backend, f"dp_profile_rank{rank}.txt", "b")
    del model, step, state
    return launches, timing


def step_collectives(torch, run, backend: str, table: str, label: str) -> dict:
    """A step's time by CUDA events (median of 2 × TRAIN_STEPS), its host
    issue time (DP_ISSUE_STEPS steps), and from one profiled step the
    kernels' time and the collectives' count, time and share (table in
    ``chiprun_out/<table>``); prints one line → {"step_ms", "coll_ms",
    "issue_ms", "n_coll"}."""
    step_ms = time_ms(torch, run, iters=TRAIN_STEPS, reps=2, warmup=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_ISSUE_STEPS):
        run()
    issue_ms = (time.perf_counter() - t0) * 1e3 / DP_ISSUE_STEPS
    torch.cuda.synchronize()
    with profiling(torch, cpu=True) as prof:
        run()
    averages = prof.key_averages()
    # gloo runs each collective on its own host thread ("gloo:<op>" spans, the
    # copies to and from the card included); NCCL runs it in kernels
    host_coll = sum(e.cpu_time_total for e in averages
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.key.startswith("gloo:")) / 1e3
    n_coll = sum(e.count for e in averages if e.key.startswith(("gloo:", "nccl:")))
    dev_coll = sum(e.self_device_time_total for e in device_kernels(torch, averages)
                   if "nccl" in e.key.lower()) / 1e3
    busy = sum(e.self_device_time_total for e in device_kernels(torch, averages)) / 1e3
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    kernels = device_kernels(torch, averages)
    gemms = sorted((e for e in kernels if any(w in e.key.lower() for w in GEMM_NAMES)),
                   key=lambda e: -e.self_device_time_total)
    gemm_ms = sum(e.self_device_time_total for e in gemms) / 1e3
    with open(os.path.join(out_dir, table), "w") as f:
        f.write(averages.table(sort_by="cpu_time_total", row_limit=40))
        f.write("\nBy device time:\n")
        f.write(averages.table(sort_by="self_device_time_total", row_limit=40))
    coll = dev_coll if backend == "nccl" else host_coll
    print(f"  {label}: step {step_ms:.2f} ms (CUDA events, median of 2 x {TRAIN_STEPS}), "
          f"{TRAIN_B / step_ms * 1e3:.1f} global pairs/s; host issue {issue_ms:.2f} ms a step; "
          f"profiled step: kernels {busy:.2f} ms, {n_coll} collectives {coll:.2f} ms "
          f"({coll / step_ms:.1%} of the step; {backend}: NCCL kernels {dev_coll:.2f} ms, gloo "
          f"threads {host_coll:.2f} ms)", flush=True)
    print(f"  {label}: GEMM kernels {gemm_ms:.2f} ms of the {busy:.2f} ms, by kernel: "
          + "; ".join(f"{e.key[:64]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in gemms[:8]), flush=True)
    return {"step_ms": step_ms, "coll_ms": coll, "issue_ms": issue_ms, "n_coll": n_coll,
            "kernel_ms": busy, "gemm_ms": gemm_ms}


def row_parallel_products(torch, model, run, rank) -> dict:
    """(c) The row-parallel products of one step (forward pre-hooks on the
    ``Dense`` layers with ``tp_reduce``), each shape's forward and backward
    timed on rank 0 as the step runs them (``nn/layers.py::partial_product``:
    bf16 operands, one tensor-core GEMM with an f32 result) and as the f32
    GEMM of the operands widened from bf16 (``matmul_f32``), by device time,
    their forwards compared → {"calls", "bf16_ms", "f32_ms"} a step."""
    from druglamp_tpu_torch.nn import layers

    shapes = {}

    def hook(mod, args):
        key = (tuple(args[0].shape), tuple(mod.weight.shape))
        shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if getattr(m, "tp_reduce", None) is not None]
    run()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    out = {"calls": sum(shapes.values()), "bf16_ms": 0.0, "f32_ms": 0.0}
    if rank != 0:
        return out
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    for (xs, ws), n in sorted(shapes.items()):
        x, w = (torch.randn(sh, generator=g, device=DEVICE).to(torch.bfloat16).requires_grad_()
                for sh in (xs, ws))
        dy = torch.randn(xs[:-1] + ws[:1], generator=g, device=DEVICE).to(torch.bfloat16).float()
        new = lambda: torch.autograd.grad(layers.partial_product(x, w), (x, w), dy)  # noqa: E731
        old = lambda: torch.autograd.grad(                                          # noqa: E731
            layers.matmul_f32(x, w.t(), torch.bfloat16), (x, w), dy)
        with torch.no_grad():
            a, b = layers.partial_product(x, w), layers.matmul_f32(x, w.t(), torch.bfloat16)
            err, scale = (a - b).abs().max().item(), b.abs().max().item()
        bf16_ms, f32_ms = device_ms(torch, new), device_ms(torch, old)
        out["bf16_ms"] += n * bf16_ms
        out["f32_ms"] += n * f32_ms
        print(f"  c: row-parallel product x{tuple(xs)} w{tuple(ws)}, {n} a step: forward and "
              f"backward {bf16_ms * 1e3:.1f} us as bf16 GEMMs with an f32 result, "
              f"{f32_ms * 1e3:.1f} us as f32 GEMMs of widened operands; forwards differ by "
              f"{err:.3e} (max |y| {scale:.1f})", flush=True)
        if err > 1e-5 * scale:
            fail(f"phase 15 c: the bf16 row-parallel product lies {err:.3e} from the f32 one")
    print(f"  c: the {out['calls']} row-parallel products of a step: {out['bf16_ms']:.3f} ms as "
          f"run (bf16 GEMMs, f32 result) against {out['f32_ms']:.3f} ms as f32 GEMMs of "
          f"widened operands (device time, forward and backward)", flush=True)
    return out


def dp_cli(torch, attention, gcn, mesh, rank, spec):
    """(c) Phase 12's 3-epoch DrugLAMP2C2P recipe through ``cli.main`` over
    the ranks on phase 9's data with a seeded cache: the gather transport,
    global mode; every evaluation's metrics recorded (the parent compares
    the ranks'), each rank's checkpoint writes counted, launches by phase
    12's formula; then the same run resumed from its epoch-1 checkpoints
    ends with the same ``ckpt_last.pt``, bit for bit."""
    import shutil

    from druglamp_tpu_torch.cli import main as cli
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.train import trainer as trainer_mod

    root = spec["root"]
    cfg = Config()
    Trainer = trainer_mod.Trainer
    saved = (torch.save, Trainer.evaluate, Trainer._save)
    saves, evaluations = [], []

    def counting_save(obj, path, *a, **k):
        saves.append(str(path))
        return saved[0](obj, path, *a, **k)

    def recording_evaluate(self, *a, **k):
        m = saved[1](self, *a, **k)
        evaluations.append({k2: float(v) for k2, v in m.items()})
        return m

    def keeping_save(self, path, snapshot):
        saved[2](self, path, snapshot)
        if self.epoch == 1 and path.startswith(os.path.join(root, "c") + os.sep) \
                and path.endswith("ckpt_last.pt"):
            self._join_ckpt()              # the write done, and its barrier passed
            if self.primary:
                for name in ("ckpt_best.pt", "ckpt_last.pt"):
                    shutil.copy(os.path.join(root, "c", name), os.path.join(root, "r", name))
            mesh.barrier()

    def argv(work, *extra):
        return ["--model", "DrugLAMP2C2P", "--data", "synthetic", "--split", "random",
                "--data-root", root, "--config", spec["yaml"], "--work-dir",
                os.path.join(root, work), "--seed", str(SEED), "--no-comet", "--device",
                spec["device"], "--device-data", "auto", *extra]

    torch.save, Trainer.evaluate, Trainer._save = counting_save, recording_evaluate, keeping_save
    try:
        reset_counts(attention, gcn)
        t0 = time.perf_counter()
        rc = cli.main(argv("c"))
        wall = time.perf_counter() - t0
        launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
        if rc != 0:
            fail(f"phase 14 c: the CLI returned {rc} on rank {rank}")
        mine = list(saves)
        reset_counts(attention, gcn)
        rc = cli.main(argv("r", "--resume"))
        resumed = {**attention.LAUNCHES, **gcn.LAUNCHES}
        if rc != 0:
            fail(f"phase 14 c: the resumed CLI returned {rc} on rank {rank}")
    finally:
        torch.save, Trainer.evaluate, Trainer._save = saved
    if rank == 0:
        with open(os.path.join(root, "c", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        hp = records[0]
        epochs = [r for r in records if "train_loss" in r]
        test = next(r for r in records if "test_auroc" in r)
        gates = [("ssl_loss" in r, "cm_loss" in r) for r in epochs]
        n_eval = -(-VAL_PAIRS // cfg.solver.eval_batch_size)
        want = want_launches(gates, spec["steps"], n_eval)
        for r in epochs:
            print(f"  c epoch {r['epoch']} ({'+'.join(g for g, k in (('cls', 'train_loss'), ('ssl', 'ssl_loss'), ('cm', 'cm_loss')) if k in r)}, gather, "
                  f"{spec['steps']} steps of {DP_HALF} rows a rank): losses "
                  f"{[round(r[k], 5) for k in ('train_loss', 'ssl_loss', 'cm_loss') if k in r]}, val "
                  f"AUSum {r['val_ausum']:.4f}; {r['epoch_time_s'] * 1e3:.1f} ms (host clock), "
                  f"{r['pairs_per_s']:.1f} global pairs/s", flush=True)
        print(f"  c: {wall:.1f} s, hyperparams ranks {hp['ranks']}, bn_mode {hp['bn_mode']}, "
              f"device_data {hp['device_data']}; test AUROC {test['test_auroc']:.4f}, AUPRC "
              f"{test['test_auprc']:.4f}; rank 0 launches {launches} (formula {want})", flush=True)
        values = [r[k] for r in epochs for k in ("train_loss", "ssl_loss", "cm_loss", "val_ausum")
                  if k in r] + [test[k] for k in ("test_auroc", "test_auprc", "test_loss")]
        if not all(math.isfinite(v) for v in values):
            fail(f"phase 14 c: non-finite losses or metrics {values}")
        if hp["ranks"] != DP_WORLD or not hp["device_data"]:
            fail(f"phase 14 c: ran over {hp['ranks']} ranks, device_data {hp['device_data']}")
        if launches != want:
            fail(f"phase 14 c: launches {launches}, expected {want}")
        a = torch.load(os.path.join(root, "c", "ckpt_last.pt"), map_location="cpu",
                       weights_only=True)
        b = torch.load(os.path.join(root, "r", "ckpt_last.pt"), map_location="cpu",
                       weights_only=True)
        differ = [k for k in a["model"] if not torch.equal(a["model"][k], b["model"][k])]
        print(f"  c: resumed from the epoch-1 checkpoints: ckpt_last.pt of epoch "
              f"{b['host']['epoch']} vs the unbroken run's (epoch {a['host']['epoch']}): "
              f"{len(differ)} of {len(a['model'])} leaves differ", flush=True)
        if differ or a["host"] != b["host"]:
            fail(f"phase 14 c: the resumed run differs: {differ[:5]}")
    total = {k: launches[k] + resumed[k] for k in launches}
    return {"evaluations": evaluations, "saves": mine, "launches": total}


def dp_rank(root: str) -> None:
    """One rank of phase 14 (``python3 chip_smoke.py --dp-rank <dir>`` with
    torchrun's variables): (a), (b) and (c) → <dir>/rank<r>.json."""
    global DEVICE
    sys.path.insert(0, REPO)
    import torch

    from druglamp_tpu_torch.kernels import attention, gcn
    from druglamp_tpu_torch.parallel.distributed import join_group
    from druglamp_tpu_torch.parallel.mesh import MeshContext, make_mesh

    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    dev = join_group(spec["device"], spec["backend"])      # the CLI's call
    DEVICE = str(dev)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = MeshContext(make_mesh(1))
    rank = mesh.rank
    print(f"rank {rank} of {mesh.n_data} on {DEVICE} ({torch.cuda.get_device_name(dev)}), "
          f"{spec['backend']}", flush=True)
    dp_f32_checks(torch, mesh, rank)
    launches, b = dp_bf16_steps(torch, attention, gcn, mesh, rank, spec["backend"])
    c = dp_cli(torch, attention, gcn, mesh, rank, spec)
    c_launches = c.pop("launches")
    total = {k: launches[k] + c_launches[k] for k in launches}
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump({"b": b, "c": c, "launches": total}, f)
    torch.distributed.destroy_process_group()


# --- phase 15: the model axis over two ranks ------------------------------------------------

TP_WORLD = 2
TP_TIMEOUT_S = 480
# (B, H, L, S, D, paired) at a model rank's heads: H/M of the 4 at M = 2 and 4
TP_CASES = [(B, H, 256, 256, D, paired) for B in (TRAIN_B, 32) for H in (2, 1)
            for D, paired in ((64, True), (128, False))]
ESM_PROTEINS = 6                 # (e)'s dataset: proteins and drugs for --gen-embed-only
TIMES = ("t", "epoch_time_s", "pairs_per_s")       # a record's host-clock keys


def attention_bound(B, H, L, S, D, paired, backward) -> tuple:
    """(bound ms, "bytes" | "operations") of one bf16 attention call: each
    input read once and each output written once over the HBM rate, or its
    products over the bf16 peak (fwd_timing's and bwd_kernel_record's count)."""
    n_q = 2 if paired else 1
    q_elems, kv_elems = B * H * L * D, B * H * S * D
    if backward:   # q sets, K, V and the incoming gradients in; one gradient per input out
        bytes_ = 2 * (2 * (n_q * q_elems + 2 * kv_elems) + n_q * q_elems)
        flops = n_q * 10 * B * H * L * S * D
    else:
        bytes_ = 2 * (n_q * q_elems + 2 * kv_elems + n_q * q_elems)
        flops = n_q * 4 * B * H * L * S * D
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def queued_ms(torch, fn, iters: int = 50, tries: int = 4) -> tuple:
    """Device time per call of ``fn`` by CUDA events around ``iters`` calls
    queued behind a lead-in spin kernel, so the card runs them back to back
    whatever the host's issue time (the gaps between kernels included): a
    second clock beside the profiler's → (ms, the host's issue time of the
    ``iters`` calls in ms).  The calls were queued only if the start event,
    recorded after the spin, is still pending once the host has issued them
    all; else the host was slower than the spin (a busy host), and the calls
    are issued again behind a lead-in 4 times longer.  Fails after ``tries``."""
    fn()
    torch.cuda.synchronize()
    cycles = LEAD_IN_CYCLES
    for attempt in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        queued = not start.query()            # the spin still runs
        end.record()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters, issue_ms
        print(f"  (queued_ms, try {attempt + 1}: issuing {iters} calls took {issue_ms:.1f} ms, "
              f"past the lead-in of {cycles} cycles; again behind one 4 times longer)",
              flush=True)
        cycles *= 4
    fail(f"queued_ms: the host issued {iters} calls slower than the lead-in in {tries} tries")


def tp_kernel_times(torch, attention, B: int, H: int) -> dict:
    """Each attention kernel in bf16 at a model rank's shape (B, H of 4,
    L=S=256), forward and backward, by the profiler's device time in two
    windows one after the other and by ``queued_ms``, beside its plain
    version and its bound → {name: {"ms" (the first window), "ms_again",
    "queued_ms", "plain_ms", "bound_ms"}}.  Called in phase 7 with the other
    kernel timings: late in a long run the profiler drops kernel records
    (read from phase 15, a window once held none)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    out = {}
    for paired in (True, False):
        D = 64 if paired else 128
        ins = make_operands(torch, g, B, H, 256, 256, D, torch.bfloat16, paired)
        q_o = ins[3] if paired else None
        dos = [torch.randn(ins[0].shape, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(2 if paired else 1)]
        outs, lse = attention.launch_forward(*ins[:3], q_o, with_lse=True)
        fwd = lambda: attention.launch_forward(*ins[:3], q_o)                    # noqa: E731
        bwd = lambda: attention.launch_backward(*ins[:3], q_o, outs, lse, dos)   # noqa: E731
        if paired:
            plain_fwd = lambda: attention.paired_attention_plain(*ins)          # noqa: E731
            plain_bwd = lambda: attention.paired_attention_bwd_plain(*ins, *dos)  # noqa: E731
        else:
            plain_fwd = lambda: attention.self_attention_plain(*ins)            # noqa: E731
            plain_bwd = lambda: attention.self_attention_bwd_plain(*ins, *dos)  # noqa: E731
        kind = "paired" if paired else "self"
        for stage, kernel, plain, own in (
                ("fwd", fwd, plain_fwd, {"attention_fwd": 1}),
                ("bwd", bwd, plain_bwd, {"attention_dq": 1, "attention_dkv": 1})):
            ms, plain_ms = device_ms(torch, kernel, own), device_ms(torch, plain)
            again = device_ms(torch, kernel, own)
            queued, issue_ms = queued_ms(torch, kernel)
            bound_ms, bound_by = attention_bound(B, H, 256, 256, D, paired, stage == "bwd")
            name = f"{kind}_attention_{stage}"
            out[name] = {"ms": ms, "ms_again": again, "queued_ms": queued, "plain_ms": plain_ms,
                         "bound_ms": bound_ms}
            print(f"  {name} bf16 B={B} H={H} L=S=256 D={D} (a model rank's shape): device "
                  f"time {ms * 1e3:.2f} us, again {again * 1e3:.2f} us (a second window), "
                  f"{queued * 1e3:.2f} us by CUDA events over 50 queued calls (issued in "
                  f"{issue_ms:.1f} ms); plain "
                  f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}), "
                  f"kernel / bound {ms / bound_ms:.2f}", flush=True)
    return out


def write_small_dataset(root: str):
    """``<root>/small/random/{train,val,test}.csv``: ESM_PROTEINS proteins of
    50–1022 residues and as many of SMILES's drugs, one pair each (for the
    encoders of phase 15 e)."""
    import numpy as np

    prots = make_proteins(np.random.RandomState(SEED + 15), ESM_PROTEINS)
    split = os.path.join(root, "small", "random")
    os.makedirs(split)
    rows = [f"{SMILES[i % len(SMILES)]},{p},{i % 2}" for i, p in enumerate(prots)]
    for name in ("train.csv", "val.csv", "test.csv"):
        with open(os.path.join(split, name), "w") as f:
            f.write("\n".join(["SMILES,Protein,Y"] + rows) + "\n")


def read_records(path: str) -> list:
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in TIMES} for line in f]


def read_caches(path: str) -> dict:
    import numpy as np

    return {n: np.load(os.path.join(path, n)) for n in sorted(os.listdir(path))}


def tp_checks(torch, attention, smi):
    """Phase 15: (a) the attention kernels at a model rank's heads, here; then
    TP_WORLD ranks of this script (``--tp-rank``) as one model axis: (b), (c),
    (d) and (e), (d) and (e) against one-process runs of the same flags made
    here first → the launches of the main path ((c) and (d)) summed over the
    ranks, and (a)'s worst bf16 error per kernel."""
    import tempfile

    import numpy as np

    from druglamp_tpu_torch.cli import main as cli
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.dataset import DTIDataset

    print(f"  a: the attention kernels at H/M heads of 4 (M = 2, 4), B = {TRAIN_B} and 32, "
          f"against their plain versions at phase 3's tolerances", flush=True)
    _, fwd_errs = kernel_checks(torch, attention, TP_CASES)
    _, bwd_errs = backward_checks(torch, attention, TP_CASES)
    errs = {}
    for (name, _, _), e in list(fwd_errs.items()) + list(bwd_errs.items()):
        errs[name] = max(errs.get(name, 0.0), e)
    backend, device, how = dp_plan(torch)
    print(f"  {TP_WORLD} ranks as a model axis (--mesh-model {TP_WORLD}, n_data 1): {how}; card: "
          f"{smi}", flush=True)
    torch.cuda.empty_cache()
    os.environ["DRUGLAMP_PACKED_GCN"] = "1"      # the one-process runs, as the ranks'

    cfg = Config()
    with tempfile.TemporaryDirectory() as root:
        write_dataset(root)
        write_small_dataset(root)
        train = DTIDataset(root, "synthetic", "random", "train.csv", max_nodes=cfg.drug.max_nodes,
                           max_prot_resis=cfg.protein.max_resis, seq_len=cfg.protein.seq_len)
        cache = os.path.join(root, "embed_cache")
        seed_cache(cache, train.table, cfg)
        yaml_path = cli_yaml(root, "DrugLAMP2C2P", FIT_EPOCHS)
        spec = {"backend": backend, "device": device, "root": root, "yaml": yaml_path,
                "steps": len(train) // cfg.solver.batch_size}
        for work in ("d1", "d2"):
            os.makedirs(os.path.join(root, work))
            os.symlink(cache, os.path.join(root, work, "embed_cache"))
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        if cli.main(tp_cli_argv(spec, "d1", DEVICE)) != 0:
            fail("phase 15 d: the one-process CLI run failed")
        if cli.main(tp_esm_argv(spec, "e1", DEVICE)) != 0:
            fail("phase 15 e: the one-process --gen-embed-only run failed")
        print(f"  d, e: the one-process runs in {time.perf_counter() - t0:.1f} s", flush=True)
        outs = run_ranks("--tp-rank", root, backend, TP_WORLD, TP_TIMEOUT_S, "phase 15")
        one, two = (read_records(os.path.join(root, w, "metrics.jsonl")) for w in ("d1", "d2"))
        caches = [read_caches(os.path.join(root, w, "embed_cache")) for w in ("e1", "e2")]
    first, second = outs
    least = min(outs, key=lambda o: o["c"]["coll_ms"])["c"]
    print(f"  c: collectives {least['coll_ms']:.2f} ms of a {least['step_ms']:.2f} ms step "
          f"({least['coll_ms'] / least['step_ms']:.1%}) on the rank that waited least; the ranks' "
          f"readings {[round(o['c']['coll_ms'], 2) for o in outs]} ms", flush=True)
    if first["d"]["evaluations"] != second["d"]["evaluations"]:
        fail("phase 15 d: the ranks' validation and test metrics differ")
    if second["d"]["saves"] or not first["d"]["saves"]:
        fail(f"phase 15 d: checkpoints written by rank 1 {second['d']['saves']}, by rank 0 "
             f"{first['d']['saves']}")
    print(f"  d: the --mesh-model {TP_WORLD} run's {len(two)} records against the one-process "
          f"run's {len(one)}: {'equal value for value' if one == two else 'DIFFERENT'} (host "
          f"clock keys left out); metrics identical on both ranks "
          f"({len(first['d']['evaluations'])} evaluations); checkpoints from rank 0 only "
          f"({len(first['d']['saves'])} writes)", flush=True)
    if one != two:
        fail(f"phase 15 d: the records differ: {[(a, b) for a, b in zip(one, two) if a != b][:2]}")
    ref, got = caches
    if sorted(ref) != sorted(got) or not ref:
        fail(f"phase 15 e: cache files {sorted(got)[:4]} vs {sorted(ref)[:4]}")
    files = {kind: [n for n in ref if f"_{kind}_" in n] for kind in ("prot", "drug")}
    cache_err = {kind: max(float(np.abs(got[n] - ref[n]).max()) for n in names)
                 for kind, names in files.items() if names}
    if len(cache_err) != 2 or any(got[n].shape != ref[n].shape for n in ref):
        fail(f"phase 15 e: cache files {sorted(ref)}")
    print(f"  e: --gen-embed-only --mesh-model {TP_WORLD} (ESM-2 t30 column-parallel, seeded "
          f"random init; ChemBERTa on rank 0), {len(files['prot'])} protein and "
          f"{len(files['drug'])} drug caches against the one-process run's: ESM-2 max |Δ| "
          f"{cache_err['prot']:.3e} (tol {ESM_ATOL:g}), ChemBERTa {cache_err['drug']:.3e} (tol "
          f"{CB_ATOL:g}); {first['e']['split']} ESM-2 leaves split on each rank", flush=True)
    if cache_err["prot"] > ESM_ATOL or cache_err["drug"] > CB_ATOL:
        fail(f"phase 15 e: the sharded caches differ from one process's: {cache_err}")
    total = {}
    for out in outs:
        for k, v in out["launches"].items():
            total[k] = total.get(k, 0) + v
    return total, errs


def tp_cli_argv(spec, work, device, *extra):
    return ["--model", "DrugLAMP2C2P", "--data", "synthetic", "--split", "random",
            "--data-root", spec["root"], "--config", spec["yaml"], "--work-dir",
            os.path.join(spec["root"], work), "--seed", str(SEED), "--no-comet", "--device",
            device, "--device-data", "auto", *extra]


def tp_esm_argv(spec, work, device, *extra):
    return ["--model", "DrugLAMP2C2P", "--data", "small", "--split", "random", "--data-root",
            spec["root"], "--work-dir", os.path.join(spec["root"], work), "--seed", str(SEED),
            "--no-comet", "--device", device, "--n-layer", "30", "--gen-embed-only", *extra]


def tp_f32_checks(torch, mesh, rank, split):
    """(b) DrugLAMP2C2P's full-gate step at ``Config()`` in f32, dropout 0.1
    (both ranks and the one-process step draw from one generator seed), the
    fixed MLM mask, a batch of TRAIN_B: the gradients over the model axis,
    gathered, against the one-process step's (rank 0; losses 1e-5,
    gradients rtol 5e-3 / atol 5e-5); then one step in each grad mode: the
    replicated leaves bit-identical on both ranks, the gradient each AdamW
    applied (its first moment over 1 - beta1, gathered) within the gradient
    tolerance of the one-process step's, the gathered parameters within
    AdamW's first-step reach of it (2·lr a loss: a first step moves an entry
    ±lr whatever its gradient's size)."""
    import dataclasses

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.encoding import decode_batch
    from druglamp_tpu_torch.losses import masking
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train import steps
    from druglamp_tpu_torch.train.state import TrainState

    cfg = Config()
    cfg32 = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                compute_dtype="float32"))
    saved, masking.mlm_mask = masking.mlm_mask, dp_fixed_mask
    batch = full_gate_batch(torch, cfg32)
    one = torch.ones((), device=DEVICE)

    def model_for(sharded):
        return build_model("DrugLAMP2C2P", cfg32, generator=torch.Generator().manual_seed(SEED),
                           mesh=mesh if sharded else None).to(DEVICE).train()

    def grads_of(model):
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        with steps.train_numerics():
            cls, ssl, cm, _, _, g = steps.loss_gradients(model, decode_batch(dict(batch)), gen,
                                                         True, True, False, MARGIN, one)
        names = [n for n, _ in model.named_parameters()]
        return [float(cls), float(ssl), float(cm)], {k: dict(zip(names, v)) for k, v in g.items()}

    model = model_for(True)
    losses, grads = grads_of(model)
    grads = {k: mesh.gather_params(model, values=v) for k, v in grads.items()}
    if rank == 0:
        ref_losses, ref = grads_of(model_for(False))
        worst, bad = 0.0, []
        for loss in ("cls", "ssl", "cm"):
            for n, r in ref[loss].items():
                worst = max(worst, (grads[loss][n] - r).abs().max().item())
                if not torch.allclose(grads[loss][n], r, rtol=5e-3, atol=5e-5):
                    bad.append((loss, n))
        dloss = max(abs(a - r) for a, r in zip(losses, ref_losses))
        print(f"  b: f32 full gate, dropout 0.1, over the model axis ({len(split)} leaves "
              f"sharded) vs one process: losses {['%.7f' % x for x in losses]} vs "
              f"{['%.7f' % x for x in ref_losses]}, max |Δ| {dloss:.3e} (tol 1e-5); 3 × "
              f"{len(ref['cls'])} gradient leaves gathered, max |Δg| {worst:.3e} (rtol 5e-3, "
              f"atol 5e-5), {len(bad)} outside", flush=True)
        if bad or dloss > 1e-5:
            fail(f"phase 15 b: the model axis's step differs from one process: {bad[:5]}")
        del ref
    del grads
    mesh.barrier()
    lrs = (F32_LR, SSL_LR, CM_LR)
    for grad_mode in steps.GRAD_MODES:
        model = model_for(True)
        state = TrainState.create(model, True, True)
        step = steps.make_train_step(model, True, True, calibrate=True, grad_mode=grad_mode,
                                     device=DEVICE)
        step(state, batch, torch.Generator(device=DEVICE).manual_seed(SEED), *lrs, MARGIN, 1.0)
        local = model.state_dict()
        same = dp_same_on_ranks(torch, mesh, [v for k, v in local.items() if k not in split])
        whole = mesh.gather_params(model)
        moments = tp_applied_gradients(mesh, model, state)
        print(f"  b: {grad_mode}: after one step, {len(local) - len(split)} replicated parameters "
              f"and buffers {'bit-identical' if same else 'DIFFERENT'} on the {TP_WORLD} ranks",
              flush=True)
        if not same:
            fail(f"phase 15 b: {grad_mode}: the ranks' replicated leaves differ after a step")
        del model, state, step, local
        if rank == 0:
            ref_model = model_for(False)
            ref_state = TrainState.create(ref_model, True, True)
            ref_step = steps.make_train_step(ref_model, True, True, calibrate=True,
                                             grad_mode=grad_mode, device=DEVICE)
            ref_step(ref_state, batch, torch.Generator(device=DEVICE).manual_seed(SEED), *lrs,
                     MARGIN, 1.0)
            ref_moments = tp_applied_gradients(mesh, ref_model, ref_state)
            worst_g, bad = 0.0, []
            for opt, named in ref_moments.items():
                for n, r in named.items():
                    worst_g = max(worst_g, (moments[opt][n] - r).abs().max().item())
                    if not torch.allclose(moments[opt][n], r, rtol=5e-3, atol=5e-5):
                        bad.append((opt, n))
            reach = 2.1 * sum(lrs)
            diffs = {k: (whole[k].float() - v.float()).abs()
                     for k, v in ref_model.state_dict().items() if v.is_floating_point()}
            worst = max(d.max().item() for d in diffs.values())
            n_far = sum(int((d > 1e-6).sum()) for d in diffs.values())
            n_all = sum(d.numel() for d in diffs.values())
            print(f"  b: {grad_mode}: the gradients each AdamW applied (first moment / (1 - "
                  f"beta1), gathered) vs one process's: 3 x {len(ref_moments['opt_cls'])} "
                  f"leaves, max |dg| {worst_g:.3e}, {len(bad)} outside rtol 5e-3 / atol 5e-5; "
                  f"the gathered parameters max |d| {worst:.3e} (AdamW's first-step reach "
                  f"2*sum(lr) = {reach:.1e}), {n_far} of {n_all} entries beyond 1e-6",
                  flush=True)
            if bad or worst > reach:
                fail(f"phase 15 b: {grad_mode}: the step's update differs from one process's: "
                     f"{bad[:5]}, parameters {worst:.3e}")
            del ref_model, ref_state, ref_step, ref_moments
        del whole, moments
        torch.cuda.empty_cache()
        mesh.barrier()
    masking.mlm_mask = saved


def tp_applied_gradients(mesh, model, state) -> dict:
    """After one step, each AdamW's first moment over 1 - beta1 (the gradient
    it applied), gathered whole → {optimizer: {name: tensor}}."""
    from druglamp_tpu_torch.train.state import B1

    out = {}
    for name in ("opt_cls", "opt_ssl", "opt_cm"):
        opt = getattr(state, name)
        named = {n: opt.state[p]["exp_avg"] / (1 - B1) for n, p in model.named_parameters()}
        out[name] = mesh.gather_params(model, values=named)
    return out


def tp_bf16_steps(torch, attention, gcn, mesh, rank, backend):
    """(c) TRAIN_STEPS bf16 full-gate steps at ``Config()`` over the model
    axis, every rank on the whole batch of TRAIN_B and one generator seed:
    each rank's launches by phase 10's one-process formula, every attention
    kernel launched at H/M heads; the losses against TRAIN_STEPS one-process
    bf16 steps (rank 0, after the counts are read); the step by CUDA
    events, host issue time, the collectives → (launches, timing)."""
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_train_step

    cfg = Config()
    batch = full_gate_batch(torch, cfg)

    def run(sharded):
        model = build_model("DrugLAMP2C2P", cfg, generator=torch.Generator().manual_seed(SEED),
                            mesh=mesh if sharded else None)
        step = make_train_step(model, True, True, calibrate=True, device=DEVICE)
        state = TrainState.create(model, True, True)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        w, outs = 1e-3, []
        for _ in range(TRAIN_STEPS):
            outs.append(step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, w))
            w = outs[-1].cm_weight
        torch.cuda.synchronize()
        losses = [[float(getattr(o, k)) for o in outs] for k in ("cls_loss", "ssl_loss",
                                                                 "cm_loss")]
        return model, step, state, gen, w, losses

    heads = set()
    saved = attention.launch_forward, attention.launch_backward

    def fwd(q, *a, **k):
        heads.add(("fwd", q.shape[1]))
        return saved[0](q, *a, **k)

    def bwd(q, *a, **k):
        heads.add(("bwd", q.shape[1]))
        return saved[1](q, *a, **k)

    reset_counts(attention, gcn)
    attention.launch_forward, attention.launch_backward = fwd, bwd
    try:
        model, step, state, gen, w, losses = run(True)
    finally:
        attention.launch_forward, attention.launch_backward = saved
    launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
    want = {k: TRAIN_STEPS * v for k, v in FULL_GATE_PER_STEP.items()}
    print(f"  c: {TRAIN_STEPS} bf16 full-gate steps over the model axis; rank {rank} launches "
          f"{launches} (one-process formula {want}); attention heads a launch "
          f"{sorted(heads)}; cls losses {['%.5f' % x for x in losses[0]]}", flush=True)
    if launches != want:
        fail(f"phase 15 c: rank {rank} launches {launches}, expected {want}")
    if heads != {("fwd", 4 // TP_WORLD), ("bwd", 4 // TP_WORLD)}:
        fail(f"phase 15 c: attention launched at heads {sorted(heads)}")
    if not all(math.isfinite(x) for row in losses for x in row):
        fail("phase 15 c: non-finite losses")
    timing = step_collectives(
        torch, lambda: step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, w), backend,
        f"tp_profile_rank{rank}.txt", "c")
    timing["row_parallel"] = row_parallel_products(
        torch, model, lambda: step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, w), rank)
    del model, step, state
    if rank == 0:
        ref = run(False)[5]
        diff = [max(abs(a - b) for a, b in zip(x, y)) for x, y in zip(losses, ref)]
        print(f"  c: against {TRAIN_STEPS} one-process bf16 steps: max |Δ| of the cls, ssl and "
              f"cm losses {['%.3e' % d for d in diff]} (one-process cls losses "
              f"{['%.5f' % x for x in ref[0]]})", flush=True)
        timing["loss_diff"] = diff
    mesh.barrier()
    return launches, timing


def tp_cli(torch, attention, gcn, mesh, rank, spec):
    """(d) Phase 12's 3-epoch DrugLAMP2C2P recipe through ``cli.main`` with
    ``--mesh-model TP_WORLD`` (gather transport, a seeded cache): every
    evaluation's metrics recorded (the parent compares the ranks', and the
    records with the one-process run's), each rank's checkpoint writes
    counted, launches by phase 12's formula."""
    from druglamp_tpu_torch.cli import main as cli
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.train import trainer as trainer_mod

    Trainer = trainer_mod.Trainer
    saved = (torch.save, Trainer.evaluate)
    saves, evaluations = [], []

    def counting_save(obj, path, *a, **k):
        saves.append(str(path))
        return saved[0](obj, path, *a, **k)

    def recording_evaluate(self, *a, **k):
        m = saved[1](self, *a, **k)
        evaluations.append({k2: float(v) for k2, v in m.items()})
        return m

    torch.save, Trainer.evaluate = counting_save, recording_evaluate
    try:
        reset_counts(attention, gcn)
        rc = cli.main(tp_cli_argv(spec, "d2", spec["device"], "--mesh-model", str(TP_WORLD)))
        launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
    finally:
        torch.save, Trainer.evaluate = saved
    if rc != 0:
        fail(f"phase 15 d: the CLI returned {rc} on rank {rank}")
    cfg = Config()
    with open(os.path.join(spec["root"], "d1", "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "train_loss" in r]
    gates = [("ssl_loss" in r, "cm_loss" in r) for r in epochs]
    want = want_launches(gates, spec["steps"], -(-VAL_PAIRS // cfg.solver.eval_batch_size))
    print(f"  d: rank {rank}: launches {launches} (phase 12's formula {want})", flush=True)
    if launches != want:
        fail(f"phase 15 d: launches {launches}, expected {want}")
    return {"evaluations": evaluations, "saves": saves, "launches": launches}


def tp_rank(root: str) -> None:
    """One rank of phase 15 (``python3 chip_smoke.py --tp-rank <dir>`` with
    torchrun's variables): (b), (c), (d), (e) → <dir>/rank<r>.json."""
    global DEVICE
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.kernels import attention, gcn
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.parallel.distributed import join_group
    from druglamp_tpu_torch.parallel.mesh import MeshContext, make_mesh, tp_plan

    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    dev = join_group(spec["device"], spec["backend"])      # the CLI's call
    DEVICE = str(dev)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = MeshContext(make_mesh(TP_WORLD))
    rank = dist.get_rank()
    print(f"rank {rank}: data rank {mesh.rank} of {mesh.n_data}, model rank {mesh.model_rank} of "
          f"{mesh.n_model} on {DEVICE} ({torch.cuda.get_device_name(dev)}), {spec['backend']}",
          flush=True)
    probe = build_model("DrugLAMP2C2P", Config())
    split = {f"{p}.{k}" for p, s in tp_plan(probe, TP_WORLD).items() for k in s}
    del probe
    tp_f32_checks(torch, mesh, rank, split)
    launches, c = tp_bf16_steps(torch, attention, gcn, mesh, rank, spec["backend"])
    d = tp_cli(torch, attention, gcn, mesh, rank, spec)
    e = tp_esm(torch, mesh, rank, spec)
    total = {k: launches[k] + d["launches"][k] for k in launches}
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump({"c": c, "d": d, "e": e, "launches": total}, f)
    dist.destroy_process_group()


def tp_esm(torch, mesh, rank, spec) -> dict:
    """(e) ``--gen-embed-only --mesh-model TP_WORLD`` through ``cli.main``
    (the split that ``generate_embeddings`` applies is recorded; the parent
    compares the caches), then ESM-2 t30 from the same seeded weights on the
    small dataset's first batch of the pipeline, f32, column-parallel
    against whole (rank 0) → {"split": its leaves split, "f32_err"}."""
    from druglamp_tpu_torch.cli import main as cli
    from druglamp_tpu_torch.data.dataset import DTIDataset
    from druglamp_tpu_torch.encoders import embed_pipeline
    from druglamp_tpu_torch.encoders.esm2 import (ESM2, ESM_PAD, esm2_config_for_layers,
                                                  esm_tokenize)
    from druglamp_tpu_torch.encoders.layers import seeded_state
    from druglamp_tpu_torch.encoders.sharding import shard_encoder

    splits = []
    saved = embed_pipeline.shard_encoder
    embed_pipeline.shard_encoder = lambda m, ms: splits.append(saved(m, ms)) or splits[-1]
    try:
        rc = cli.main(tp_esm_argv(spec, "e2", spec["device"], "--mesh-model", str(TP_WORLD)))
    finally:
        embed_pipeline.shard_encoder = saved
    if rc != 0 or len(splits) != 1 or not splits[0]:
        fail(f"phase 15 e: --gen-embed-only returned {rc} on rank {rank}, splits "
             f"{[len(x) for x in splits]}")
    table = DTIDataset(spec["root"], "small", "random", "train.csv").table
    todo = [(o, esm_tokenize(seq, 1022)) for seq, o in table.prot2ord.items()]
    _, toks, lens = next(embed_pipeline._batched(todo, ENCODER_BATCH, ESM_PAD))
    cfg = esm2_config_for_layers(30)
    enc = ESM2(cfg).eval()
    enc.load_state_dict(seeded_state(enc, 0))
    whole = ESM2(cfg).eval().to(DEVICE) if rank == 0 else None
    if whole is not None:
        whole.load_state_dict(enc.state_dict())
    shard_encoder(enc, mesh)
    got = encoder_forward(torch, enc.to(DEVICE), toks, DEVICE)
    err = (max_row_err(got, encoder_forward(torch, whole, toks, DEVICE), lens)
           if whole is not None else None)
    if rank == 0:
        print(f"  e: ESM-2 t30 column-parallel ({len(splits[0])} leaves split, heads 20 → 10 a "
              f"rank) against whole, f32, one {toks.shape[0]} × {toks.shape[1]} batch: max |Δ| "
              f"{err:.3e} (tol {ESM_ATOL:g})", flush=True)
        if err > ESM_ATOL:
            fail(f"phase 15 e: the column-parallel ESM-2 lies {err:.3e} from the whole one")
    del enc, whole
    return {"split": len(splits[0]), "f32_err": err}


# --- phase 16: the leftovers ---------------------------------------------------------------

LINATTN_PER_STEP = {"paired_attention_fwd": 4, "self_attention_fwd": 0,
                    "paired_attention_bwd": 4, "self_attention_bwd": 0}


def linattn_checks(torch, attention):
    """(a) DrugLAMPwoLLM with ``pmma_variant="linattn"`` at ``Config()``: one
    bf16 cls step (finite, 4 paired forward and backward launches, no self
    attention); then in f32 with dropout 0 the step's gradients through the
    kernels and through the plain attention, from the same weights (losses
    1e-5, gradients rtol 5e-3 / atol 5e-5) → the bf16 step's launches."""
    import dataclasses

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.encoding import compact_batch
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_train_step
    from druglamp_tpu_torch.utils.synthetic import make_batch

    def run(cfg, plain):
        model = build_model("DrugLAMPwoLLM", cfg, generator=torch.Generator().manual_seed(SEED),
                            pmma_variant="linattn")
        host = make_batch(cfg, TRAIN_B, seed=SEED, n_drug_feature=384, n_prot_feature=640)
        batch = compact_batch(host, (host["d_fill"] == 0).sum(1))
        step = make_train_step(model, False, False, device=DEVICE)
        attention.reset_launch_counts()
        with plain_attention(attention) if plain else contextlib.nullcontext():
            out = step(TrainState.create(model), batch,
                       torch.Generator(device=DEVICE).manual_seed(SEED), TRAIN_LR)
            loss = float(out.cls_loss)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        return loss, grads, dict(attention.LAUNCHES)

    cfg = Config()
    loss, _, launches = run(cfg, False)
    print(f"  a: linattn, bf16 cls step: loss {loss:.5f}; launches {launches} (want "
          f"{LINATTN_PER_STEP})", flush=True)
    if not math.isfinite(loss) or launches != LINATTN_PER_STEP:
        fail(f"phase 16 a: the linattn step: loss {loss}, launches {launches}")
    cfg32 = dataclasses.replace(cfg, pmma_dropout=0.0, solver=dataclasses.replace(
        cfg.solver, compute_dtype="float32"))
    (l_k, g_k, _), (l_p, g_p, n_p) = run(cfg32, False), run(cfg32, True)
    bad = [n for n in g_k if not torch.allclose(g_k[n], g_p[n], rtol=5e-3, atol=5e-5)]
    worst = max((g_k[n] - g_p[n]).abs().max().item() for n in g_k)
    print(f"  a: linattn, f32, dropout 0, kernels vs plain attention: loss {l_k:.7f} vs "
          f"{l_p:.7f} (tol 1e-5); {len(g_k)} gradient leaves, max |Δg| {worst:.3e} (rtol 5e-3, "
          f"atol 5e-5), {len(bad)} outside; the plain run's launches {n_p}", flush=True)
    if bad or abs(l_k - l_p) > 1e-5 or any(n_p.values()):
        fail(f"phase 16 a: linattn f32 step differs from its plain-attention run: {bad[:5]}")
    return launches


def fast_dev_checks(torch, attention, gcn, train, val, data, emb):
    """(b) ``Trainer.fast_dev_run`` on phase 9's data: DrugLAMP2C2P at
    ``Config()`` with ssl and cm on, FAST_DEV_BATCHES training batches of 16
    over the host pipeline (the ordinal store), the validation pass over the
    device-resident dataset; finite losses, the launches of its steps and
    eval batches, nothing written → the launches."""
    import dataclasses
    import tempfile

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.loader import BatchLoader
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.trainer import Trainer

    base = Config()
    cfg = dataclasses.replace(base, rs=dataclasses.replace(base.rs, ssl=True, cm=True),
                              solver=dataclasses.replace(base.solver, eval_batch_size=EVAL_B))
    loaders = (BatchLoader(train, TRAIN_B, shuffle=True, drop_last=True, seed=SEED,
                           emb_ordinals=True),
               BatchLoader(val, EVAL_B, shuffle=False, drop_last=False, emb_ordinals=True),
               BatchLoader(val, EVAL_B, shuffle=False, drop_last=False, emb_ordinals=True))
    with tempfile.TemporaryDirectory() as work:
        model = build_model("DrugLAMP2C2P", cfg, generator=torch.Generator().manual_seed(SEED))
        t = Trainer(model, cfg, *loaders, work_dir=work, embed_store=emb, device_data=data,
                    device=DEVICE)
        reset_counts(attention, gcn)
        t0 = time.perf_counter()
        res = t.fast_dev_run(SEED, n_batches=FAST_DEV_BATCHES)
        wall = time.perf_counter() - t0
        launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
        written = os.listdir(work)
    n_eval = -(-len(val) // EVAL_B)
    want = {k: FAST_DEV_BATCHES * v for k, v in FULL_GATE_PER_STEP.items()}
    for k, v in CLI_PER_EVAL_BATCH.items():
        want[k] += n_eval * v
    print(f"  b: fast_dev_run: {FAST_DEV_BATCHES} batches in {wall:.1f} s, cls losses "
          f"{['%.5f' % x for x in res['train_losses']]}, val AUROC {res['val_auroc']:.4f}, "
          f"AUPRC {res['val_auprc']:.4f}, loss {res['val_loss']:.5f}; launches {launches} "
          f"(want {want}); files written {written}", flush=True)
    if not all(math.isfinite(x) for x in res["train_losses"]) or written or launches != want:
        fail(f"phase 16 b: fast_dev_run: {res}, launches {launches}, written {written}")
    return launches


FAST_DEV_BATCHES = 4


# --- phase 17: the flat AdamW, the checkpoint writes, the profiling tools and the ----------
# --- dense host batches ---------------------------------------------------------------------

SWITCH_FIT_EPOCHS = 3
SWITCH_FIT_PAIRS = 128        # (b)'s fit: 8 steps an epoch, one eval batch of each split
FLAT_STEPS = 20


def flat_opt_checks(torch, attention, gcn):
    """Phase 17 (a): FLAT_STEPS f32 cls steps of DrugLAMP at ``Config()``
    with the per-leaf AdamW, the gradient each step applied given to a
    ``FlatAdamW`` over a copy of the starting parameters: the copy within
    rtol 1e-5 / atol 1e-7 of the model after the steps; then one bf16
    full-gate step of DrugLAMP2C2P (packed GCN) with the per-leaf and with
    the flat optimizers from one seed and one set of weights: equal losses,
    parameters within rtol 1e-5 / atol 1e-7, each kernel's launches; the
    step by CUDA events, its peak memory (nothing of the other optimizer's
    run resident) and its kernel launches (profiled) → the launches of the
    two counted steps, the main path of this phase."""
    import dataclasses

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import FlatAdamW, TrainState, apply_optimizer
    from druglamp_tpu_torch.train.steps import make_train_step
    from druglamp_tpu_torch.utils.synthetic import make_batch

    base = Config()
    cfg32 = dataclasses.replace(base, solver=dataclasses.replace(base.solver,
                                                                 compute_dtype="float32"))
    model = build_model("DrugLAMP", cfg32, generator=torch.Generator().manual_seed(SEED))
    model.to(DEVICE)
    shadow = [torch.nn.Parameter(p.detach().clone()) for p in model.parameters()]
    flat = FlatAdamW(shadow)
    state = TrainState.create(model, flat_opt=False)
    step = make_train_step(model, False, False, device=DEVICE)
    batch = make_batch(cfg32, TRAIN_B, seed=SEED, n_drug_feature=384, n_prot_feature=640)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    for _ in range(FLAT_STEPS):
        step(state, batch, gen, TRAIN_LR)
        for q, p in zip(shadow, model.parameters()):
            q.grad = p.grad
        apply_optimizer(flat, TRAIN_LR)
    torch.cuda.synchronize()
    worst, bad = 0.0, []
    for (name, p), q in zip(model.named_parameters(), shadow):
        worst = max(worst, (p - q).abs().max().item())
        if not torch.allclose(q, p, rtol=1e-5, atol=1e-7):
            bad.append(name)
    print(f"  a: {FLAT_STEPS} f32 cls steps, the flat AdamW on each step's gradients against "
          f"the per-leaf AdamW: {len(shadow)} leaves ({sum(q.numel() for q in shadow)} entries), "
          f"max |Δp| {worst:.3e}, {len(bad)} outside rtol 1e-5 / atol 1e-7; count "
          f"{int(flat.count)}", flush=True)
    if bad:
        fail(f"phase 17 a: the flat AdamW disagrees with the per-leaf one: {bad[:5]}")
    del model, state, step, shadow, flat

    os.environ["DRUGLAMP_PACKED_GCN"] = "1"
    batch = full_gate_batch(torch, base)
    main_launches, runs = {}, {}
    for flat_opt in (False, True):
        label = "flat" if flat_opt else "per-leaf"
        model = build_model("DrugLAMP2C2P", base, generator=torch.Generator().manual_seed(SEED))
        model.to(DEVICE)
        state = TrainState.create(model, True, True, flat_opt=flat_opt)
        step = make_train_step(model, True, True, calibrate=True, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
        reset_counts(attention, gcn)
        out = step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, 1e-3)
        torch.cuda.synchronize()
        launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
        for k, v in launches.items():
            main_launches[k] = main_launches.get(k, 0) + v
        runs[label] = ([float(getattr(out, k)) for k in ("cls_loss", "ssl_loss", "cm_loss",
                                                          "cm_weight")],
                       [p.detach().clone() for p in model.parameters()])
        run = lambda: step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN,   # noqa: E731
                           out.cm_weight)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, run, iters=3, reps=3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profiling(torch) as prof:
            last = run()
        n_kernels = sum(e.count for e in device_kernels(torch, prof.key_averages()))
        print(f"  a: bf16 full-gate step with the {label} AdamW: launches {launches}; "
              f"{ms:.2f} ms (CUDA events, median of 3 x 3), peak {peak:.3f} GiB, {n_kernels} "
              f"kernel launches a step; losses {runs[label][0]}", flush=True)
        if not all(math.isfinite(float(getattr(last, k)))
                   for k in ("cls_loss", "ssl_loss", "cm_loss")):
            fail(f"phase 17 a: non-finite loss with the {label} AdamW")
        del model, state, step, out, last, run
    (l0, p0), (l1, p1) = runs["per-leaf"], runs["flat"]
    worst = max((a - b).abs().max().item() for a, b in zip(p0, p1))
    bad = sum(not torch.allclose(b, a, rtol=1e-5, atol=1e-7) for a, b in zip(p0, p1))
    print(f"  a: flat against per-leaf after the full-gate step: losses equal {l0 == l1}, max "
          f"|Δp| {worst:.3e}, {bad} of {len(p0)} leaves outside rtol 1e-5 / atol 1e-7", flush=True)
    if l0 != l1 or bad:
        fail(f"phase 17 a: the flat full-gate step disagrees: losses {l1} vs {l0}, {bad} leaves")
    return main_launches


# --- phase 19: the multi-tensor AdamW kernel ------------------------------------------------

ADAMW_STEPS = 20


def adamw_checks(torch, launches: int = 0):
    """Phase 19: the AdamW kernel on DrugLAMP2C2P's leaves against torch's
    foreach capturable AdamW, then its device time beside its bound, its
    host issue time, and torch's step back to back → its record, with the
    main path's ``launches`` (phases 6 and 9; main adds phase 10's)."""
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.kernels import adamw
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import apply_optimizer, make_adamw

    shapes = [p.shape for p in build_model("DrugLAMP2C2P", Config(),
                                           generator=torch.Generator().manual_seed(SEED)
                                           ).parameters()]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    start = [torch.randn(s, device=DEVICE, generator=gen) for s in shapes]
    ours = [torch.nn.Parameter(t.clone()) for t in start]
    ref = [torch.nn.Parameter(t.clone()) for t in start]
    opt = make_adamw(ours)
    ref_opt = torch.optim.AdamW(ref, lr=0.0, betas=(adamw.B1, adamw.B2), eps=adamw.EPS,
                                weight_decay=adamw.WEIGHT_DECAY, foreach=True, capturable=True)
    adamw.reset_launch_counts()
    for k in range(ADAMW_STEPS):
        lr = TRAIN_LR * 0.9 ** k
        for p, q in zip(ours, ref):
            p.grad = q.grad = torch.randn(p.shape, device=DEVICE, generator=gen)
        apply_optimizer(opt, lr)
        ref_opt.param_groups[0]["lr"] = lr
        ref_opt.step()
    torch.cuda.synchronize()
    worst, bad = 0.0, 0
    for p, q in zip(ours, ref):
        for a, b in [(p, q)] + [(opt.state[p][k], ref_opt.state[q][k])
                                for k in ("exp_avg", "exp_avg_sq", "step")]:
            worst = max(worst, (a - b).abs().max().item())
            bad += not torch.allclose(a, b, rtol=1e-5, atol=1e-7)
    n = sum(p.numel() for p in ours)
    print(f"  {len(ours)} leaves, {n} entries: {ADAMW_STEPS} kernel steps against torch's "
          f"foreach capturable AdamW: max |d| {worst:.3e}, {bad} tensors outside rtol 1e-5 / "
          f"atol 1e-7; launches {adamw.LAUNCHES}", flush=True)
    if bad or adamw.LAUNCHES["adamw"] != ADAMW_STEPS:
        fail(f"phase 19: the AdamW kernel disagrees with torch's ({bad} tensors) or launched "
             f"{adamw.LAUNCHES} times for {ADAMW_STEPS} steps")
    kernel = lambda: apply_optimizer(opt, TRAIN_LR)     # noqa: E731
    # queued CUDA events, not device_ms: late in the run the profiler lost every
    # record of a 50-call window of this kernel, 8 windows in 8, and kept the
    # 100-call window's (the host issues a call in about 1 ms, the card runs it
    # in 0.15)
    ms, issue_ms = queued_ms(torch, kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ADAMW_STEPS):
        ref_opt.step()
    torch.cuda.synchronize()
    torch_ms = (time.perf_counter() - t0) / ADAMW_STEPS * 1e3
    bound_ms = 28 * n / HBM_BYTES_PER_S * 1e3
    print(f"  a step: kernel {ms * 1e3:.2f} us on the card ({bound_ms / ms:.1%} of its bytes "
          f"bound {bound_ms * 1e3:.2f} us), issued in {issue_ms / 50:.3f} ms; torch's foreach "
          f"step {torch_ms:.3f} ms back to back", flush=True)
    if not ms * 1e3 <= 250:
        fail(f"phase 19: the AdamW kernel takes {ms * 1e3:.2f} us a step, over 250 us")
    return {"name": "adamw", "launches": launches, "leaves": len(ours), "entries": n,
            "max_abs_err": worst, "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "host_ms": issue_ms / 50, "library_step_ms": torch_ms}


def head_split(ds, n: int):
    """The first ``n`` pairs of a dataset split (a shallow copy; the same
    entity table)."""
    import copy

    out = copy.copy(ds)
    out.rows, out.drug_ords, out.prot_ords, out.labels = (
        ds.rows[:n], ds.drug_ords[:n], ds.prot_ords[:n], ds.labels[:n])
    return out


def checkpoint_checks(torch, train, val, test, data, emb):
    """Phase 17 (b): the recipe's SWITCH_FIT_EPOCHS-epoch fit
    (DrugLAMP2C2P, bf16, packed GCN, ``ckpt_every`` 1) on the first
    SWITCH_FIT_PAIRS training pairs and EVAL_B validation and test pairs,
    with asynchronous writes and with ``DRUGLAMP_SYNC_CKPT=1``: equal files, each epoch's wall
    time; a Trainer from other weights resumed from the asynchronous epoch-2
    ``ckpt_last.pt`` ends with the unbroken run's."""
    import dataclasses
    import shutil
    import tempfile

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
        solver=dataclasses.replace(base.solver, max_epoch=SWITCH_FIT_EPOCHS, ckpt_every=1,
                                   cm_lr=CM_LR, eval_batch_size=EVAL_B))
    splits = (BatchLoader(head_split(train, SWITCH_FIT_PAIRS), TRAIN_B, shuffle=True,
                          drop_last=True, seed=SEED),
              BatchLoader(head_split(val, EVAL_B), EVAL_B, shuffle=False, drop_last=False),
              BatchLoader(head_split(test, EVAL_B), EVAL_B, shuffle=False, drop_last=False))

    def trainer(work, seed, log=None):
        model = build_model("DrugLAMP2C2P", cfg, generator=torch.Generator().manual_seed(seed))
        t = Trainer(model, cfg, *splits, logger=log, work_dir=work, embed_store=emb,
                    device_data=data, device=DEVICE)
        t.patience = base.solver.max_epoch // 4
        return t, TrainState.create(model, True, True)

    def load(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b

    with tempfile.TemporaryDirectory() as tmp:
        walls = {}
        for label, sync in (("async", "0"), ("sync", "1")):
            os.environ["DRUGLAMP_SYNC_CKPT"] = sync
            log = ExperimentLogger(tmp, label, quiet=True)
            t, state = trainer(os.path.join(tmp, label), SEED, log)
            save = t._save

            def keep_epoch2(path, snapshot, t=t, label=label):
                save(path, snapshot)
                if path.endswith("ckpt_last.pt") and t.epoch == 2:
                    t._join_ckpt()
                    shutil.copy(path, os.path.join(tmp, f"{label}_epoch2.pt"))

            t._save = keep_epoch2
            t0 = time.perf_counter()
            t.run_experiment(SEED, state=state)
            fit_s = time.perf_counter() - t0
            log.close()
            with open(log.jsonl_path) as f:
                walls[label] = [r["epoch_time_s"] for r in map(json.loads, f) if "train_loss" in r]
            print(f"  b: {label} checkpoint writes (async_ckpt {t.async_ckpt}): epoch walls "
                  f"{['%.1f ms' % (w * 1e3) for w in walls[label]]} (host clock, the epoch's "
                  f"call and its loss sums), fit and test {fit_s:.1f} s", flush=True)
            del t, state
        os.environ["DRUGLAMP_SYNC_CKPT"] = "0"
        differ = [name for name in ("ckpt_best.pt", "ckpt_last.pt")
                  if not same(load(os.path.join(tmp, "async", name)),
                              load(os.path.join(tmp, "sync", name)))]
        differ += [] if same(load(os.path.join(tmp, "async_epoch2.pt")),
                             load(os.path.join(tmp, "sync_epoch2.pt"))) else ["epoch 2"]
        resume = os.path.join(tmp, "resumed")
        os.makedirs(resume)
        shutil.copy(os.path.join(tmp, "async_epoch2.pt"), os.path.join(resume, "ckpt_last.pt"))
        tr, state = trainer(resume, SEED + 1)
        tr.restore(os.path.join(resume, "ckpt_last.pt"), state)
        tr.fit(state, SEED, start_epoch=tr.epoch + 1)
        resumed = same(load(os.path.join(resume, "ckpt_last.pt")),
                       load(os.path.join(tmp, "async", "ckpt_last.pt")))
        print(f"  b: async against sync files (best, last, epoch 2): {differ or 'all equal'}; "
              f"the resume from the async epoch-2 ckpt_last.pt ends equal to the unbroken "
              f"run: {resumed}", flush=True)
        if differ or not resumed or len(walls["async"]) != SWITCH_FIT_EPOCHS:
            fail(f"phase 17 b: async checkpoints: differ {differ}, resumed equal {resumed}")


class SeededEmbeddings:
    """Seeded random embeddings at the real token lengths, in memory: a
    drug len(SMILES) + 2 rows, a protein min(len, max_resis) + 2 (phase
    17 d's embedding source)."""

    def __init__(self, table, cfg):
        import numpy as np

        self.n_drug_feature, self.n_prot_feature = 384, 640
        rng = np.random.RandomState(SEED + 21)
        self._drug = {o: rng.randn(min(len(s) + 2, cfg.drug.max_nodes), 384).astype(np.float32)
                      for s, o in table.drug2ord.items()}
        self._prot = {o: rng.randn(min(len(s), cfg.protein.max_resis) + 2, 640)
                      .astype(np.float32) for s, o in table.prot2ord.items()}

    def drug(self, ordinal):
        return self._drug[ordinal]

    def prot(self, ordinal):
        return self._prot[ordinal]


def profiling_dense_checks(torch, attention, train, fwd_record):
    """Phase 17 (c) and (d): ``utils.profiling.device_time_ms`` of the paired
    forward at the serving shape beside ``device_ms``'s reading (phase 5),
    and a ``trace``; the native packer built on this machine, and a dense
    batch (``compact=False``, bf16 LLM arrays, native adjacency) through
    ``decode_batch`` giving the compact batch's forward bit for bit."""
    import tempfile

    from druglamp_tpu_torch.chem import native
    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.encoding import decode_batch
    from druglamp_tpu_torch.data.loader import BatchLoader
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.steps import to_device
    from druglamp_tpu_torch.utils import profiling as prof_mod

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    q, k, v, q_o = make_operands(torch, g, 32, 4, 256, 256, 64, torch.bfloat16, True)
    ms = prof_mod.device_time_ms(attention.paired_attention, q, k, v, q_o, n1=10, n2=40)
    with tempfile.TemporaryDirectory() as tmp:
        with prof_mod.trace(tmp):
            attention.paired_attention(q, k, v, q_o)
        files = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        sizes = [os.path.getsize(f) for f in files]
    print(f"  c: paired forward bf16 B=32: utils.profiling.device_time_ms {ms * 1e3:.2f} us a "
          f"call (CUDA events, two-point 10/40 calls: the host's issue rate when it exceeds the "
          f"kernel's) beside device_ms {fwd_record['ms'] * 1e3:.2f} us (the profiler's kernel "
          f"time, phase 5); trace(): {len(files)} file(s), {sizes} bytes", flush=True)
    if not (math.isfinite(ms) and ms > 0) or not files or not all(sizes):
        fail(f"phase 17 c: device_time_ms {ms}, trace files {files} {sizes}")

    t0 = time.perf_counter()
    built = native.available()
    print(f"  d: native runtime {'built' if built else 'NOT built'} at "
          f"{native.loaded_path()} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not built:
        fail("phase 17 d: the native featurization runtime did not build on this machine")
    cfg = Config()
    emb = SeededEmbeddings(train.table, cfg)
    dense = BatchLoader(train, TRAIN_B, shuffle=False, drop_last=False, embeddings=emb,
                        compact=False).first_batch()
    compact = BatchLoader(train, TRAIN_B, shuffle=False, drop_last=False,
                          embeddings=emb).first_batch()
    model = build_model("DrugLAMP", cfg, generator=torch.Generator().manual_seed(SEED))
    model.to(DEVICE).eval()
    with torch.no_grad():
        dense_in = decode_batch(to_device(dense, torch.device(DEVICE)))
        compact_in = decode_batch(to_device(compact, torch.device(DEVICE)), keep_packed=False)
        a = model(dense_in)["score"]
        b = model(compact_in)["score"]
    torch.cuda.synchronize()
    keys = sorted(k for k in dense if k != "cm")
    print(f"  d: dense batch of {TRAIN_B} ({', '.join(f'{k} {dense[k].dtype}' for k in keys)}; "
          f"{sum(dense[k].nbytes for k in keys) / 1e6:.1f} MB against the compact "
          f"{sum(v.nbytes for k, v in compact.items() if k != 'cm') / 1e6:.1f} MB): DrugLAMP "
          f"bf16 forward scores {a.flatten()[:4].tolist()}, equal to the compact batch's "
          f"{torch.equal(a, b)}", flush=True)
    if not torch.equal(a, b) or not torch.isfinite(a).all():
        fail("phase 17 d: the dense batch's forward differs from the compact batch's")
    del model


def switch_checks(torch, attention, gcn, smi, train, val, test, data, emb, fwd_record):
    """Phase 17 → the launches of its main path ((a)'s bf16 full-gate steps)."""
    print(f"  card: {smi}", flush=True)
    t0 = time.perf_counter()
    launches = flat_opt_checks(torch, attention, gcn)
    print(f"  (a took {time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    checkpoint_checks(torch, train, val, test, data, emb)
    print(f"  (b took {time.perf_counter() - t0:.1f} s)", flush=True)
    profiling_dense_checks(torch, attention, train, fwd_record)
    return launches


# --- phase 18: DRUGLAMP_REMAT -------------------------------------------------------------------

REMAT_MODES = ("none", "dots", "full")
REMAT_EPOCH_STEPS = 4
REMAT_BIG_B = 64             # (d): the peak at four times the recipe's batch
REMAT_TIMED_STEPS = 3
# what a full-gate step launches under dots and full: the forward kernels again in each
# recompute, PMMA's blocks once (only the cls gradient reaches them), each GCN layer once for
# each of the three gradients (all reach the GCN tokens); the backwards as eager
REMAT_PER_STEP = {**FULL_GATE_PER_STEP,
                  "paired_attention_fwd": 2 * FULL_GATE_PER_STEP["paired_attention_fwd"],
                  "self_attention_fwd": 2 * FULL_GATE_PER_STEP["self_attention_fwd"],
                  "gcn_packed_matmul": 4 * FULL_GATE_PER_STEP["gcn_packed_matmul"]}
# an allocation's region: the outermost of these frames in its stack ((file, function) → label)
REGION_FRAMES = {("models/ssl.py", "prot_mlm"): "SSL MLM part (re-encode included)",
                 ("models/ssl.py", "drug_simsiam"): "SSL SimSiam part",
                 ("models/cm.py", "forward"): "CM head",
                 ("nn/gcn.py", "forward"): "MolecularGCN",
                 ("nn/protein_cnn.py", "forward"): "ProteinCNN",
                 ("models/base.py", "_encode_prot_llm"): "LLM adaptors",
                 ("models/base.py", "_encode_drug_llm"): "LLM adaptors",
                 ("models/base.py", "_fuse_v"): "fusion (GCA + MHLA + LN)",
                 ("models/base.py", "_fuse_x"): "fusion (GCA + MHLA + LN)",
                 ("nn/pmma.py", "forward"): "PMMA",
                 ("nn/mlp.py", "forward"): "MLP head"}


@contextlib.contextmanager
def remat_env(mode: str):
    """``DRUGLAMP_REMAT=mode`` for the block (the step reads it when built)."""
    saved = os.environ.get("DRUGLAMP_REMAT")
    os.environ["DRUGLAMP_REMAT"] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("DRUGLAMP_REMAT")
        else:
            os.environ["DRUGLAMP_REMAT"] = saved


def block_label(frames) -> str:
    """The region of an allocation from its Python frames (innermost first): the
    outermost ``REGION_FRAMES`` frame, marked when a checkpoint's recompute made
    it; else its innermost frame of the port, or of the step."""
    port = [f for f in frames if "druglamp_tpu_torch/" in f["filename"]]
    recompute = any(f["filename"].endswith("utils/checkpoint.py") and f["name"] == "unpack_hook"
                    for f in frames)
    label = None
    for f in port:
        key = (f["filename"].split("druglamp_tpu_torch/")[-1], f["name"])
        label = REGION_FRAMES.get(key, label)
    if label is None:
        if not port:
            return "no frame of the port (autograd's C++ backward)"
        f = port[0]
        label = f"{f['filename'].split('druglamp_tpu_torch/')[-1]}:{f['line']} {f['name']}"
    return label + (" [recomputed]" if recompute else "")


def block_site(frames) -> str:
    """An allocation's innermost frame of the port, marked as ``block_label``
    marks a recompute's."""
    label = block_label(frames)
    port = [f for f in frames if "druglamp_tpu_torch/" in f["filename"]]
    if not port:
        return label
    f = port[0]
    return (f"{f['filename'].split('druglamp_tpu_torch/')[-1]}:{f['line']} {f['name']}"
            + (" [recomputed]" if label.endswith("[recomputed]") else ""))


def _by_label(blocks, key=block_label) -> list:
    """[(bytes, label)] of (size, frames) blocks, largest first."""
    sums = {}
    for size, frames in blocks:
        label = key(frames) if frames else "allocated before the step"
        sums[label] = sums.get(label, 0) + size
    return sorted(((b, k) for k, b in sums.items()), reverse=True)


def step_memory(torch, run) -> dict:
    """One call of ``run`` (a train step) with the allocator's history on
    (``torch.cuda.memory._record_memory_history``, Python stacks): the bytes
    allocated before it (``base``), when its first gradient starts (the
    forward's and the losses' tensors that the graph keeps, ``at_grad``) and
    at its peak (``torch.cuda.max_memory_allocated`` after a reset); the
    holders at the first gradient (``memory_snapshot()``'s active blocks
    then) and at the peak (the history's allocations and frees replayed up
    to it), by region (``block_label``) and, at the peak, by allocating line
    (``block_site``); and which part of the step the peak fell in (the
    forward or one of its gradients)."""
    grad = torch.autograd.grad
    seen = {"highs": []}         # the peak so far when each gradient starts

    def first_grad(*a, **k):
        if not seen["highs"]:
            torch.cuda.synchronize()
            seen["at_grad"] = torch.cuda.memory_allocated()
            seen["blocks"] = [(b["size"], b.get("frames")) for s in torch.cuda.memory_snapshot()
                              for b in s["blocks"] if b["state"] == "active_allocated"]
        seen["highs"].append(torch.cuda.max_memory_allocated())
        return grad(*a, **k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python",
                                             max_entries=2_000_000)
    torch.autograd.grad = first_grad
    try:
        run()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.autograd.grad = grad
        torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated()
    stages = ("the forward", "the cls gradient", "the ssl gradient", "the cm gradient")
    peak_in = stages[sum(h < peak for h in seen["highs"])]
    live, cur, best, best_i = {}, 0, 0, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            cur += e["size"]
        elif e["action"] in ("free_requested", "free_completed") and e["addr"] in live:
            cur -= live.pop(e["addr"])
        if cur > best:
            best, best_i = cur, i
    live = {}
    for e in trace[:best_i + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames") or [{"filename": "?", "line": 0,
                                                               "name": "?"}])
        elif e["action"] in ("free_requested", "free_completed"):
            live.pop(e["addr"], None)
    return {"base": base, "at_grad": seen.get("at_grad", 0), "peak": peak, "peak_in": peak_in,
            "replayed_peak": base + best, "events": len(trace),
            "at_grad_holders": _by_label(seen.get("blocks", [])),
            "peak_holders": _by_label(live.values()),
            "peak_sites": _by_label(live.values(), block_site)}


def write_holders(f, label: str, mem: dict) -> None:
    gib = 2 ** 30
    f.write(f"{label}: base {mem['base'] / gib:.3f} GiB, at the first gradient "
            f"{mem['at_grad'] / gib:.3f} GiB, peak {mem['peak'] / gib:.3f} GiB in "
            f"{mem['peak_in']} (replayed "
            f"{mem['replayed_peak'] / gib:.3f}, {mem['events']} allocator events)\n")
    for key in ("at_grad_holders", "peak_holders", "peak_sites"):
        f.write(f"  {key}:\n")
        for b, name in mem[key][:40]:
            f.write(f"    {b / 2 ** 20:10.1f} MiB  {name}\n")


def remat_step_outputs(torch, model, state, out, gen) -> tuple:
    """What a step must give the same under every mode: its outputs, every
    parameter and buffer, each optimizer's moments, the generator's state;
    copied to the host, so the next mode's step starts from the same
    device memory."""
    moments = [t.detach().cpu() for opt in (state.opt_cls, state.opt_ssl, state.opt_cm)
               for p in model.parameters() for t in opt.state[p].values()
               if isinstance(t, torch.Tensor)]
    return ([getattr(out, k).detach().cpu() for k in ("cls_loss", "ssl_loss", "cm_loss",
                                                       "probs", "cm_weight")],
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
            moments, gen.get_state())


def remat_differ(a, b) -> list:
    """The parts of two ``remat_step_outputs`` that are not bit-identical."""
    (oa, sa, ma, ga), (ob, sb, mb, gb) = a, b
    bad = [f"output {i}" for i, (x, y) in enumerate(zip(oa, ob)) if not _equal(x, y)]
    bad += [k for k in sa if not _equal(sa[k], sb[k])]
    bad += [f"moment {i}" for i, (x, y) in enumerate(zip(ma, mb)) if not _equal(x, y)]
    return bad + ([] if _equal(ga, gb) else ["generator"])


def _equal(x, y) -> bool:
    return x.shape == y.shape and x.dtype == y.dtype and x.equal(y)


def remat_step(torch, cfg, mode, batch, gen_seed, grad_mode="per_loss"):
    """DrugLAMP2C2P's full-gate step under ``DRUGLAMP_REMAT=mode``, weights
    from SEED → (model, state, step, generator)."""
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_train_step

    model = build_model("DrugLAMP2C2P", cfg, generator=torch.Generator().manual_seed(SEED))
    with remat_env(mode):
        step = make_train_step(model, True, True, calibrate=True, grad_mode=grad_mode,
                               device=DEVICE)
    return (model, TrainState.create(model, True, True, flat_opt=False), step,
            torch.Generator(device=DEVICE).manual_seed(gen_seed))


def remat_f32_checks(torch):
    """(a): the f32 full-gate step (dropout as configured, packed GCN) in both
    grad modes, dots and full against none, bit for bit; the remat steps
    under TF32 settings of the caller's (the step's own numerics cover the
    recompute)."""
    import dataclasses

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.train.steps import GRAD_MODES

    base = Config()
    cfg32 = dataclasses.replace(base, solver=dataclasses.replace(base.solver,
                                                                 compute_dtype="float32"))
    batch = full_gate_batch(torch, cfg32)
    for grad_mode in GRAD_MODES:
        runs = {}
        for mode in REMAT_MODES:
            model, state, step, gen = remat_step(torch, cfg32, mode, batch, SEED + 21, grad_mode)
            with tf32_flags(torch, mode != "none", "high" if mode != "none" else "highest"):
                out = step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, 1e-3)
            torch.cuda.synchronize()
            runs[mode] = remat_step_outputs(torch, model, state, out, gen)
            del model, state, step, out
        differ = {m: remat_differ(runs["none"], runs[m]) for m in ("dots", "full")}
        print(f"  a: f32 full-gate step, {grad_mode}: losses {[float(x) for x in runs['none'][0][:3]]}"
              f"; against none, the parts that differ: dots {len(differ['dots'])}, full "
              f"{len(differ['full'])} (of {len(runs['none'][1]) + len(runs['none'][2]) + 6}: "
              f"outputs, state, moments, generator)", flush=True)
        if any(differ.values()):
            fail(f"phase 18 a: remat's f32 step ({grad_mode}) is not none's: {differ}")


def remat_bf16_checks(torch, attention, gcn):
    """(b): the bf16 full-gate step at batch TRAIN_B under each mode from one
    seed and one set of weights: bit-identical to none; each kernel's
    launches against REMAT_PER_STEP; the second step's memory
    (``step_memory``) and the step by CUDA events → (the launches of the
    counted dots and full steps, {mode: peak bytes})."""
    from druglamp_tpu_torch.config import Config

    cfg = Config()
    batch = full_gate_batch(torch, cfg)
    runs, main, peaks, mems = {}, {}, {}, {}
    for mode in REMAT_MODES:
        gc.collect()
        model, state, step, gen = remat_step(torch, cfg, mode, batch, SEED + 22)
        reset_counts(attention, gcn)
        out = step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, 1e-3)
        torch.cuda.synchronize()
        launches = {**attention.LAUNCHES, **gcn.LAUNCHES}
        runs[mode] = remat_step_outputs(torch, model, state, out, gen)
        want = FULL_GATE_PER_STEP if mode == "none" else REMAT_PER_STEP
        if mode != "none":
            for k, v in launches.items():
                main[k] = main.get(k, 0) + v
        w = out.cm_weight
        run = lambda: step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, w)   # noqa: E731
        mems[mode] = mem = step_memory(torch, run)
        peaks[mode] = mem["peak"]
        ms = time_ms(torch, run, iters=REMAT_TIMED_STEPS, reps=3, warmup=1)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        print(f"  b: bf16 full-gate step, batch {TRAIN_B}, {mode}: launches {launches}; "
              f"{ms:.2f} ms (CUDA events, median of 3 x {REMAT_TIMED_STEPS}); memory base "
              f"{mem['base'] / 2 ** 30:.3f} GiB, at the first gradient "
              f"{mem['at_grad'] / 2 ** 30:.3f} GiB, peak {mem['peak'] / 2 ** 30:.3f} GiB in "
              f"{mem['peak_in']} (replayed {mem['replayed_peak'] / 2 ** 30:.3f}; the step's own "
              f"{(mem['peak'] - mem['base']) / 2 ** 30:.3f}); after {REMAT_TIMED_STEPS * 3 + 1} "
              f"more steps {after / 2 ** 30:.3f} GiB", flush=True)
        if after > mem["base"] + 2 ** 20:
            fail(f"phase 18 b: {mode} steps leave memory behind: {mem['base']} B before, "
                 f"{after} B after")
        for key in ("at_grad_holders", "peak_holders", "peak_sites"):
            print(f"     {key}: " + "; ".join(f"{name} {b / 2 ** 20:.1f} MiB"
                                             for b, name in mem[key][:6]), flush=True)
        if launches != want:
            fail(f"phase 18 b: {mode} launches {launches}, expected {want} a step")
        del model, state, step, out, run
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "remat_memory.txt"), "w") as f:
        for mode, mem in mems.items():
            write_holders(f, f"bf16 full-gate step, batch {TRAIN_B}, DRUGLAMP_REMAT={mode}", mem)
    differ = {m: remat_differ(runs["none"], runs[m]) for m in ("dots", "full")}
    print(f"  b: against none, the parts that differ: dots {len(differ['dots'])}, full "
          f"{len(differ['full'])}; peak dots / full / none {peaks['dots'] / 2 ** 30:.3f} / "
          f"{peaks['full'] / 2 ** 30:.3f} / {peaks['none'] / 2 ** 30:.3f} GiB", flush=True)
    if any(differ.values()):
        fail(f"phase 18 b: remat's bf16 step is not none's: {differ}")
    if peaks["dots"] >= peaks["none"] or peaks["full"] >= peaks["none"]:
        fail(f"phase 18 b: remat does not peak below none: {peaks}")
    return main


def remat_epoch_checks(torch, train, data, emb):
    """(c): a REMAT_EPOCH_STEPS-step gather epoch of DrugLAMP2C2P (ssl, cm,
    calibrate; bf16, packed GCN) on phase 9's dataset under full against
    none: losses, the CM weight, parameters and buffers bit-identical."""
    import numpy as np

    from druglamp_tpu_torch.config import Config
    from druglamp_tpu_torch.data.device_data import train_index_plan
    from druglamp_tpu_torch.models.registry import build_model
    from druglamp_tpu_torch.train.state import TrainState
    from druglamp_tpu_torch.train.steps import make_epoch_step_gather

    tree = data.tree_for(train)
    idx = train_index_plan(np.random.RandomState(SEED + 23).permutation(len(train)),
                           TRAIN_B)[:REMAT_EPOCH_STEPS]
    ones = np.ones(idx.shape, np.float32)
    runs = {}
    for mode in ("none", "full"):
        model = build_model("DrugLAMP2C2P", Config(),
                            generator=torch.Generator().manual_seed(SEED))
        state = TrainState.create(model, True, True, flat_opt=False)
        with remat_env(mode):
            epoch = make_epoch_step_gather(model, True, True, True, True, calibrate=True,
                                           device=DEVICE)
        out = epoch(state, idx, ones, tree, emb, torch.Generator(device=DEVICE).manual_seed(SEED),
                    TRAIN_LR, SSL_LR, CM_LR, MARGIN, 1e-3)
        torch.cuda.synchronize()
        runs[mode] = ([out.cls_losses.clone(), out.ssl_losses.clone(), out.cm_losses.clone(),
                       out.cm_weight.clone()],
                      {k: v.detach().clone() for k, v in model.state_dict().items()})
        del model, state, epoch, out
    (la, sa), (lb, sb) = runs["none"], runs["full"]
    differ = [f"loss {i}" for i, (x, y) in enumerate(zip(la, lb)) if not torch.equal(x, y)]
    differ += [k for k in sa if not torch.equal(sa[k], sb[k])]
    print(f"  c: {REMAT_EPOCH_STEPS}-step gather epoch (bf16, ssl + cm + calibrate) under full "
          f"against none: cls losses {la[0].float().cpu().numpy().round(5).tolist()}, "
          f"{len(differ)} parts differ", flush=True)
    if differ:
        fail(f"phase 18 c: remat's gather epoch is not none's: {differ[:5]}")


def remat_big_batch(torch):
    """(d): the peak of the bf16 full-gate step at batch REMAT_BIG_B under
    none and full (the second step after a reset; printed, not gated)."""
    from druglamp_tpu_torch.config import Config

    batch = full_gate_batch(torch, Config(), REMAT_BIG_B)
    peaks = {}
    for mode in ("none", "full"):
        model, state, step, gen = remat_step(torch, Config(), mode, batch, SEED + 24)
        out = step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, 1e-3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(state, batch, gen, TRAIN_LR, SSL_LR, CM_LR, MARGIN, out.cm_weight)
        torch.cuda.synchronize()
        peaks[mode] = (base, torch.cuda.max_memory_allocated())
        del model, state, step, out
    print(f"  d: bf16 full-gate step, batch {REMAT_BIG_B}: peak none "
          f"{peaks['none'][1] / 2 ** 30:.3f} GiB, full {peaks['full'][1] / 2 ** 30:.3f} GiB "
          f"(base {peaks['none'][0] / 2 ** 30:.3f} / {peaks['full'][0] / 2 ** 30:.3f} GiB)",
          flush=True)


def remat_checks(torch, attention, gcn, smi, train, data, emb):
    """Phase 18 → the launches of its main path ((b)'s dots and full steps)."""
    print(f"  card: {smi}", flush=True)
    os.environ["DRUGLAMP_PACKED_GCN"] = "1"
    t0 = time.perf_counter()
    remat_f32_checks(torch)
    print(f"  (a took {time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    launches = remat_bf16_checks(torch, attention, gcn)
    print(f"  (b took {time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    remat_epoch_checks(torch, train, data, emb)
    remat_big_batch(torch)
    print(f"  (c, d took {time.perf_counter() - t0:.1f} s)", flush=True)
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
    read.  A window of ``iters`` calls counts only if it holds every record
    it should: a window of twice as many calls just after it holds twice its
    records of every kernel, ``iters`` divides its count, and, for the
    port's kernels, it holds ``iters`` times ``own`` {name part: records per
    call} from the wrapper's ``LAUNCHES`` (``launch_delta``).  A lost record
    breaks the ratio unless both windows lose in it.  (A window of one call
    is no yardstick: in a long run it has held no record of its call, try
    after try, while the longer windows held all of theirs.)  A pair that
    does not is profiled again, up to ``tries`` times, and then the phase
    fails: no time is scaled, guessed or returned as 0."""
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
        total, window = profiled(iters)
        _, double = profiled(2 * iters)
        count, count2 = sum(window.values()), sum(double.values())
        own_n = {n: sum(c for k, c in window.items() if n in k) for n in own}
        if (count and count % iters == 0 and double == {k: 2 * c for k, c in window.items()}
                and own_n == {n: iters * k for n, k in own.items()}):
            return total / iters / 1e3
        PROFILE_RETRIES.append((count, count2))
        short = sorted(((abs(2 * window.get(k, 0) - double.get(k, 0)), k[:60])
                        for k in set(window) | set(double)), reverse=True)[:3]
        print(f"  (device_ms, try {attempt + 1}: {count} kernel records for {iters} calls, "
              f"{count2} for {2 * iters}; the port's kernels {own_n}, expected {own} a call; "
              f"furthest from twice: {short}; profiled again)", flush=True)
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
    serve_err, _ = kernel_checks(torch, attention)
    train_err, _ = backward_checks(torch, attention)
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
    tp_times = tp_kernel_times(torch, attention, TRAIN_B, 4 // TP_WORLD)   # phase 15's shape
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

    phase("12 the training CLI (druglamp_tpu_torch.cli.main)")
    print(f"  card: {smi}", flush=True)
    cli_launches = cli_checks(torch, attention, gcn)

    phase("13 the frozen encoders (ESM-2, ChemBERTa, --gen-embed)")
    print(f"  card: {smi}", flush=True)
    enc_launches = encoder_checks(torch, attention, gcn, smi)

    phase("14 data-parallel training over two ranks")
    dp_launches = dp_checks(torch, smi)

    phase("15 the model axis over two ranks (tensor parallelism)")
    print(f"  card: {smi}", flush=True)
    tp_launches, tp_errs = tp_checks(torch, attention, smi)

    phase("16 the leftovers (linattn PMMA, Trainer.fast_dev_run)")
    print(f"  card: {smi}", flush=True)
    lin_launches = linattn_checks(torch, attention)
    fdr_launches = fast_dev_checks(torch, attention, gcn, train, val, data, emb)

    phase("17 the training switches (flat AdamW, async checkpoints), profiling, the dense "
          "batches")
    sw_launches = switch_checks(torch, attention, gcn, smi, train, val, test, data, emb,
                                records[0])

    phase("18 DRUGLAMP_REMAT (block-wise rematerialisation of the train step)")
    remat_launches = remat_checks(torch, attention, gcn, smi, train, data, emb)
    del train, val, test, data, emb

    phase("19 the multi-tensor AdamW kernel")
    print(f"  card: {smi}", flush=True)
    records.append(adamw_checks(torch, train_launches["adamw"] + epoch_launches["adamw"]))
    later = (gate_launches, fit_launches, cli_launches, enc_launches, dp_launches, tp_launches,
             lin_launches, fdr_launches, sw_launches, remat_launches)
    for rec in records:        # the launches of the main path, phases 10 to 18 included
        keys = ([rec["name"]] if rec["name"] != "gcn_packed_matmul"
                else ["gcn_packed_matmul", "gcn_packed_matmul_bwd"])
        rec["launches"] += sum(run.get(k, 0) for run in later for k in keys)
        if rec["name"] in tp_times:   # at a model rank's heads (phases 7 and 15 a)
            rec.update({f"tp_{k}": v for k, v in tp_times[rec["name"]].items()},
                       tp_max_abs_err=tp_errs[rec["name"]],
                       tp_shape=f"B={TRAIN_B} H={4 // TP_WORLD} L=S=256")
    print(f"  device_ms: {len(PROFILE_RETRIES)} timing windows profiled again", flush=True)
    print(f"  total {time.perf_counter() - START:.1f} s", flush=True)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-rank":
        dp_rank(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--tp-rank":
        tp_rank(sys.argv[2])
    else:
        main()
