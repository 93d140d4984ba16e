"""The program's phase ranges in the traced segment: the ``druglamp.*`` user
annotations that ``druglamp_tpu_torch/train/steps.py`` opens, one after
another on the calling thread, while a profiler records (``druglamp.gather``,
``druglamp.forward``, ``druglamp.backward.<loss>``,
``druglamp.optimizer.<loss>``).  A range's phase is its name's second part.

Read from the host-and-device pass of ``trace.profile`` (the CUDA-only pass
records no host operator, so no range), its first call left out as
everywhere: the ranges of the main thread (the one that opened the
``portbench.window`` range) after the first call's share of them by count.
Device operations are picked by those ranges through their correlation ids,
not by count, by the window or by when the card ran them, so a device record
missing from the pass takes only its own time away, and the device clock's
drift against the host's (tens of milliseconds in a card-paced pass) moves
nothing.

- host: each phase's ranges' time under the CPU tracer, less what
  ``trace.host_issue`` leaves out of host issue: each CUDA API call's time
  beyond the median time of the pass's opening API calls (issued into an
  empty queue, so never held), the synchronising calls, and the tracer's own
  buffer work.  The API calls of every thread count (a backward's are made
  on autograd's device thread while the main thread waits in its range);
- device, launches: each device operation goes to the phase whose range
  holds the CUDA API call that launched it; copies and fills are timed but
  not counted as launches;
- idle: each gap between device operations, from the segment's first
  operation on, goes to the phase that launched the operation ending it:
  what the card was waiting for.  The tail after the last operation, and a
  gap ended by an operation launched outside the ranges, go to none;
- host waits: the calls of ``HOST_WAITS`` that start inside a range, on any
  thread.

A step is a forward range: every train step and scored batch has one.  A
trace with no range (a program without them) reduces to None.

``trace.profile`` does not call ``reduce``, and no metric reads it: that
takes ``profile`` handing its second pass's events to ``reduce`` and keeping
the result on its ``Trace``, where a reader takes ``per_step`` of it.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from harness import trace as _trace

PREFIX = "druglamp."
STEP = "druglamp.forward"
# CUDA runtime calls that make the host wait for the device
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


@dataclass
class Spans:
    steps: int                                          # forward ranges measured
    host_s: Dict[str, float] = field(default_factory=dict)     # phase → seconds
    device_s: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)
    host_waits: int = 0


def _overlap(s: int, t: int, a: int, b: int) -> int:
    return max(0, min(t, b) - max(s, a))


def reduce(raw, calls: int) -> Optional[Spans]:
    """The phases of every call but the first of a host-and-device pass."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = list(raw)
    window = [e for e in events if e.name() == _trace.SPAN and e.device_type() == cpu]
    if not window:
        return None
    a, b, main = window[0].start_ns(), window[0].end_ns(), window[0].start_thread_id()
    ranges = _trace._after_first(sorted(
        (e.start_ns(), e.end_ns(), e.name().split(".")[1], e.name()) for e in events
        if e.device_type() == cpu and e.is_user_annotation() and e.name().startswith(PREFIX)
        and e.start_thread_id() == main and a <= e.start_ns() <= b), calls)
    steps = sum(n == STEP for _, _, _, n in ranges)
    if steps == 0:
        return None
    out = Spans(steps)
    for _, _, p, _ in ranges:
        for d in (out.host_s, out.device_s, out.idle_s):
            d.setdefault(p, 0.0)
        out.launches.setdefault(p, 0)
    starts = [r[0] for r in ranges]

    def open_at(at: int) -> Optional[int]:
        i = bisect.bisect_right(starts, at) - 1
        return i if i >= 0 and ranges[i][1] >= at else None

    # the host's records as trace.host_issue sorts them: API calls (one nested
    # in another is part of it), synchronising calls, the tracer's own work
    host = sorted((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()) for e in events
                  if e.device_type() == cpu and not e.is_user_annotation())
    api, tracer, end = [], [], -1
    for s, t, n, corr in host:
        if n.startswith(_trace.TRACER):
            tracer.append((s, t))
        elif n.startswith("cu") and t > end:
            api.append((s, t, n, corr))
            end = t
    launched = {corr: s for s, t, n, corr in host if n.startswith("cu")}
    issue = [x for x in api if "Synchronize" not in x[2]]
    unheld = (statistics.median(t - s for s, t, _, _ in
                                issue[:min(_trace.OPENING_CALLS, len(issue) // calls)])
              if len(issue) >= calls else 0)
    kept = [t - s for s, t, _, _ in ranges]
    for s, t, n, _ in api:
        i = open_at(s)
        if i is not None:
            kept[i] -= t - s if "Synchronize" in n else max(0, t - s - unheld)
    for s, t in tracer:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(ranges) and ranges[i][0] < t:
            kept[i] -= _overlap(s, t, *ranges[i][:2])
            i += 1
    for (_, _, p, _), k in zip(ranges, kept):
        out.host_s[p] += max(0, k) / 1e9

    def phase(corr: int) -> Optional[str]:
        i = open_at(launched[corr]) if corr in launched else None
        return None if i is None else ranges[i][2]

    ops = sorted((e.start_ns(), e.end_ns(), e.name(), phase(e.correlation_id())) for e in events
                 if e.device_type() == cuda and not e.is_user_annotation())
    for s, t, name, p in ops:
        if p is not None:
            out.device_s[p] += (t - s) / 1e9
            out.launches[p] += not _trace._is_copy(name)
    first = min((s for s, _, _, p in ops if p is not None), default=None)
    busy_to = None
    for s, t, _, p in ops:
        if busy_to is not None and s > busy_to and p is not None and s > first:
            out.idle_s[p] += (s - busy_to) / 1e9
        busy_to = t if busy_to is None else max(busy_to, t)
    out.host_waits = sum(1 for s, _, n, _ in host if n in HOST_WAITS and open_at(s) is not None)
    return out


def per_step(spans: Optional[Spans], quantity: str, p: Optional[str] = None,
             scale: float = 1e3) -> Optional[float]:
    """A quantity of ``spans`` a step of the traced segment (``scale`` 1e3:
    seconds to milliseconds); None without a range or the phase."""
    if spans is None:
        return None
    value = getattr(spans, quantity)
    if p is not None:
        if p not in value:
            return None
        value = value[p]
    return value * scale / spans.steps
