"""Training cells: the program's device-resident epoch driver
(``train/steps.py::make_epoch_step_gather``) over the library's training
split, in chunks of steps back to back.

Set-up makes the library, the weights and the train state, then drives the
first three steps through the window's own call and feed, one step a call,
on rows that all differ, and keeps what the comparison needs: each step's
losses, each optimizer's gradient after the first step (its first moment
over 1 − β1) and each parameter's change after the third.  One chunk warms
the window's shapes.  The window then issues chunks until its seconds have
passed and ends in a synchronise: the rate is every pair of every chunk over
that whole time.  The traced segment is ``trace_calls`` more chunks, the
first left out (``harness/trace.py``).  Once the window has closed, the program is freed and the
plain reference runs the same three steps from the same weights, batches
and draws.
"""

from __future__ import annotations

import gc
import time
from typing import Iterator

import numpy as np
import torch

from harness import compare, flops, library, program, trace, weights
from harness.readers import Reading
from reference import step as ref
from reference.model import param_shapes

CHECKED_STEPS = 3


def plan(n: int, batch: int, rng) -> Iterator[np.ndarray]:
    """Batches of split indices, epoch after epoch, each epoch a new seeded
    order (the last partial batch dropped, as the program's plans drop it)."""
    while True:
        order = rng.permutation(n)
        for s in range(n // batch):
            yield order[s * batch:(s + 1) * batch]


def _norms(tensors) -> list:
    return torch.stack([t.norm() for t in tensors]).tolist()


def run(c) -> dict:
    dev, cfg, tr = c.device, c.cfg, c.traffic
    gates, B, S = tr["gates"], tr["batch"], tr["chunk_steps"]
    rec = cfg["recipe"]
    lrs = {"cls": rec["lr"], "ssl": rec["ssl_lr"], "cm": rec["cm_lr"]}
    margin, cm_weight = rec["max_margin"], tr["cm_weight"]

    c.sync()
    c.mark("interpreter, imports, CUDA context")
    lib = library.make_library(c.library, cfg, c.seed, dev)
    c.sync()
    c.mark("library and stores")
    split = lib.splits[tr["split"]]
    shapes = param_shapes(cfg)
    model = program.build_model(cfg, dev)
    c.sync()
    c.mark("model")
    w0 = weights.make_weights(shapes, c.seed, dev)
    weights.load_into(model, w0)
    c.sync()
    c.mark("weights")
    state = program.train_state(model, gates)
    epoch = program.epoch_driver(model, cfg, gates, dev)
    tree = {**lib.entities, **lib.pairs(tr["split"], dev)}
    batches = plan(len(split), B, np.random.default_rng([c.seed, 2]))
    gen = torch.Generator(device=dev).manual_seed(c.seed + 11)
    names = [k for k, _ in model.named_parameters()]
    c.sync()
    c.mark("train state and driver")

    def call(rows):
        idx = np.stack(rows).astype(np.int32)
        return epoch(state, idx, np.ones(idx.shape, np.float32), tree, lib.store, gen,
                     lrs["cls"], lrs["ssl"], lrs["cm"], margin, cm_weight)

    checked = [next(batches) for _ in range(CHECKED_STEPS)]
    got = {"losses": [], "grads": None, "change": None}
    for i, rows in enumerate(checked):
        out = call([rows])
        got["losses"].append(out)
        if i == 0:
            got["grads"] = {n: dict(zip(names, _norms(m)))
                            for n, m in program.first_moments(state).items()}
    with torch.no_grad():
        got["change"] = dict(zip(names, _norms([p - w0[k] for k, p in model.named_parameters()])))
    got["losses"] = [{n: float(getattr(o, n + "_losses")[0]) for n in ["cls", "ssl", "cm"]
                      if n == "cls" or gates[n]} for o in got["losses"]]
    del w0
    c.mark("the three checked steps (the kernels built or loaded)")
    call([next(batches) for _ in range(S)])
    c.sync()
    c.mark("one chunk of warm-up")
    setup_s = time.perf_counter() - c.t0

    losses, steps = [], 0
    start = time.perf_counter()
    while True:
        out = call([next(batches) for _ in range(S)])
        losses.append(torch.stack([out.cls_losses, out.ssl_losses, out.cm_losses], 1))
        steps += S
        if time.perf_counter() - start >= c.seconds:
            break
    c.sync()
    window = time.perf_counter() - start
    memory_peak = c.memory_peak()
    failed = int((~torch.isfinite(torch.cat(losses)).all(1)).sum())

    reading = Reading(setup_s=setup_s, rate=steps * B / window, steps_per_s=steps / window,
                      flops_per_pair=flops.flops_per_pair(cfg, True, gates),
                      attn_bound_s=flops.attention_bound_per_step(cfg, B, True),
                      gcn_bound_s=flops.gcn_bound(cfg, B),
                      gcn_calls=flops.gcn_calls_per_step(gates, True))
    if c.trace:
        reading.trace = trace.profile(lambda: call([next(batches) for _ in range(S)]),
                                      tr["trace_calls"])
        reading.steps_traced = (tr["trace_calls"] - 1) * S

    del model, state, epoch, tree, out, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, control = reference_checks(c, lib, split, checked, gates, lrs, margin, cm_weight,
                                       got)
    return {"reading": reading, "attempted": steps, "failed": failed,
            "memory_peak": memory_peak, "checks": checks, "control": control}


def reference_checks(c, lib, split, checked, gates, lrs, margin, cm_weight, got):
    """The reference's three steps, compared with the program's; with
    ``c.control`` also the control (the reference in the control's precision)
    compared with the reference."""
    cfg, dev = c.cfg, c.device
    w0 = weights.make_weights(param_shapes(cfg), c.seed, dev)
    bs = [ref.batch(lib, cfg, split[rows], dev) for rows in checked]

    def steps(precision):
        gen = torch.Generator(device=dev).manual_seed(c.seed + 11)
        out = ref.train_steps(cfg, w0, bs, gen, gates, lrs, margin, cm_weight, precision)
        with torch.no_grad():
            out["change"] = {k: (p - w0[k]).norm().item() for k, p in out["params"].items()}
        del out["params"]
        return out

    want = steps(cfg["compute_dtype"])
    c.detail.update(compare.training_detail(got, want))
    c.detail["losses"] = [[g, w] for g, w in zip(got["losses"], want["losses"])]
    c.detail["change_left_out"] = sorted(set(want["change"]) - compare.moved(want))
    checks = compare.training(got, want)
    control = compare.training(steps(c.control), want) if c.control else None
    return checks, control
