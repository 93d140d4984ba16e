"""Tracing and timing (port of ``druglamp_tpu/utils/profiling.py``).

    with trace("runs/trace"):                 # a Chrome / TensorBoard trace of the block
        out = step(state, batch, gen, lr)
    with span("druglamp.forward"):            # a named range, while a profiler records
        out = model(batch)
    ms = device_time_ms(fn, x, n1=10, n2=40)  # per call, CUDA events on the card

``span`` costs a module attribute read while no profiler records (no
allocation, no dispatcher call), so the train and eval steps mark their
phases with it unconditionally.  ``trace`` and ``device_time_ms`` run on
``cuda`` unless the caller asks for ``cpu`` (and raise when ``cuda`` is
asked for and absent).  On the card, ``device_time_ms`` reads CUDA events
around back-to-back calls: a call whose kernels take less time than the
host needs to issue them is timed by the host's issue rate, not by its
kernels' device time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch

from druglamp_tpu_torch.serve import resolve_device

_profiler = torch.autograd.profiler
_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range of the profiler's host timeline (a user annotation, on
    the clock of the card's records) around the block while a profiler
    records, else one shared context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda") -> Iterator[torch.profiler.profile]:
    """Profile the block (host activity, and the card's on a CUDA device) and
    write it to ``log_dir`` as a Chrome trace that TensorBoard's profiler
    plugin reads (``<host>_<pid>.<time>.pt.trace.json``)."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
                                ) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def device_time_ms(fn, *args, n1: int = 10, n2: int = 40, device="cuda") -> float:
    """Milliseconds per call of ``fn(*args)`` by the two-point difference
    (t(n2) − t(n1)) / (n2 − n1) of n1 and n2 back-to-back calls, which
    cancels each run's fixed costs (the first launch, the wait at its end).
    On a card each run is timed by CUDA events on the current stream; on the
    CPU (``device="cpu"``) by ``time.perf_counter``.  One call and one run of
    one call warm up first."""
    if n2 <= n1:
        raise ValueError(f"n2={n2} must exceed n1={n1}")
    dev = resolve_device(device)

    def run(iters: int) -> float:
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) * 1e3

    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        fn(*args)
        run(1)
        ta, tb = run(n1), run(n2)
    return (tb - ta) / (n2 - n1)
