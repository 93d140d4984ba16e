"""Tracing and timing (port of ``druglamp_tpu/utils/profiling.py``).

    with trace("runs/trace"):                 # a Chrome / TensorBoard trace of the block
        out = step(state, batch, gen, lr)
    timer = StepTimer()
    timer.start(); out = step(...); timer.stop(out.cls_loss)   # waits for out's device
    timer.summary()                           # steps, mean_ms, p50_ms, p90_ms, max_ms
    ms = device_time_ms(fn, x, n1=10, n2=40)  # per call, CUDA events on the card

``trace`` and ``device_time_ms`` run on ``cuda`` unless the caller asks for
``cpu`` (and raise when ``cuda`` is asked for and absent).  On the card,
``device_time_ms`` reads CUDA events around back-to-back calls: a call whose
kernels take less time than the host needs to issue them is timed by the
host's issue rate, not by its kernels' device time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from druglamp_tpu_torch.serve import resolve_device


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


def _first_tensor(tree: Any) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


class StepTimer:
    """Wall-clock step times with a percentile summary; ``stop(result)``
    first waits until the device that holds ``result`` (a tensor, or the
    first tensor of a tuple, list or dict) is done."""

    def __init__(self):
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result: Any = None) -> None:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        t = _first_tensor(result)
        if t is not None and t.is_cuda:
            torch.cuda.synchronize(t.device)
        self._times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        return {
            "steps": n,
            "mean_ms": 1000 * sum(ts) / n,
            "p50_ms": 1000 * ts[n // 2],
            "p90_ms": 1000 * ts[min(n - 1, int(0.9 * n))],
            "max_ms": 1000 * ts[-1],
        }


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
