"""Scoring cells: the program's device-resident eval driver
(``train/steps.py::make_eval_scan_gather``) scoring the whole library, pass
after pass, in batches of the traffic's size.

Set-up makes the library and the weights (BatchNorm statistics at 0 and 1)
and warms one pass.  The window issues passes until its seconds have passed
and ends in a synchronise: the rate is every pair of every pass over that
whole time.  The traced segment is ``trace_calls`` more passes, the first
left out (``harness/trace.py``).  Every pass's probabilities and batch losses are kept; once the
window has closed and the program is freed, a sample of batches drawn from
the seed (the ragged last batch always among them) is scored by the plain
reference and compared.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import compare, flops, library, program, trace, weights
from harness.readers import Reading
from reference import step as ref
from reference.model import param_shapes

REFERENCE_ROWS = 128          # the reference's rows a block


def plan(n: int, batch: int):
    """(S, B) pair indices and validity: the pairs in order, the ragged last
    batch padded with its first row."""
    steps = -(-n // batch)
    idx = np.arange(steps * batch, dtype=np.int32)
    idx[n:] = (steps - 1) * batch
    valid = (np.arange(steps * batch) < n).astype(np.float32)
    return idx.reshape(steps, batch), valid.reshape(steps, batch)


def run(c) -> dict:
    dev, cfg, tr = c.device, c.cfg, c.traffic
    B = tr["batch"]
    c.sync()
    c.mark("interpreter, imports, CUDA context")
    lib = library.make_library(c.library, cfg, c.seed, dev)
    c.sync()
    c.mark("library and stores")
    split = lib.splits[tr["split"]]
    model = program.build_model(cfg, dev)
    c.sync()
    c.mark("model")
    weights.load_into(model, weights.make_weights(param_shapes(cfg), c.seed, dev))
    score = program.eval_driver(model, dev)
    tree = {**lib.entities, **lib.pairs(tr["split"], dev)}
    idx, valid = plan(len(split), B)
    c.sync()
    c.mark("weights and driver")

    def call():
        return score(idx, valid, tree, lib.store)

    call()
    c.sync()
    c.mark("one pass of warm-up (the kernels built or loaded)")
    setup_s = time.perf_counter() - c.t0

    outs = []
    start = time.perf_counter()
    while True:
        outs.append(call())
        if time.perf_counter() - start >= c.seconds:
            break
    c.sync()
    window = time.perf_counter() - start
    memory_peak = c.memory_peak()
    batches = len(outs) * idx.shape[0]
    failed = sum(int((~torch.isfinite(l)).sum()) for _, l in outs)

    reading = Reading(setup_s=setup_s, rate=len(outs) * len(split) / window,
                      steps_per_s=batches / window,
                      flops_per_pair=flops.flops_per_pair(cfg, False, {}),
                      attn_bound_s=flops.attention_bound_per_step(cfg, B, False),
                      gcn_bound_s=flops.gcn_bound(cfg, B),
                      gcn_calls=flops.gcn_calls_per_step({}, False))
    if c.trace:
        reading.trace = trace.profile(call, tr["trace_calls"])
        reading.steps_traced = (tr["trace_calls"] - 1) * idx.shape[0]

    rng = np.random.default_rng([c.seed, 3])
    k = min(tr["checked_batches"], idx.shape[0]) - 1
    picks = [(int(rng.integers(len(outs))), int(s))
             for s in rng.choice(idx.shape[0] - 1, k, replace=False)]
    picks.append((len(outs) - 1, idx.shape[0] - 1))
    got = [(outs[p][0][s].float().cpu(), float(outs[p][1][s])) for p, s in picks]
    del model, score, tree, outs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    w = weights.make_weights(param_shapes(cfg), c.seed, dev)

    def reference(precision):
        probs, losses = [], []
        for _, s in picks:
            rows = split[idx[s][valid[s] > 0]]
            p, per = [], []
            for a in range(0, len(rows), REFERENCE_ROWS):
                b = ref.batch(lib, cfg, rows[a:a + REFERENCE_ROWS], dev)
                pr, l = ref.score(cfg, w, b, precision)
                p.append(pr.cpu())
                per.append(l.cpu())
            probs.append(torch.cat(p))
            losses.append(float(torch.cat(per).double().mean()))
        return probs, losses

    want = reference(cfg["compute_dtype"])
    mine = ([g[0][:len(want[0][i])] for i, g in enumerate(got)], [g[1] for g in got])
    checks = compare.scoring(*mine, *want)
    control = compare.scoring(*reference(c.control), *want) if c.control else None
    return {"reading": reading, "attempted": batches, "failed": failed,
            "memory_peak": memory_peak, "checks": checks, "control": control}
