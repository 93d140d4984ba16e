"""The traced segment: a fixed number of the cell's calls (chunks of steps, or
passes over the library) under ``torch.profiler``, reduced to the numbers the
per-layer readers take.

The calls run twice.  The first pass traces CUDA activity alone: each device
operation (kernels, copies, fills) and each CUDA API call the host makes,
with no host operator recorded.  The second traces host and device together,
and gives the idle gaps between device operations and the host operation
running at each gap's start.  Both start from an empty launch queue after a
synchronise, so the first call of each pass is left out of every number: the
segment measured runs from the first device operation of the second call to
the end of the last.  Calls of one cell issue the same work, so the first
call's share of the operations, by count, is where the second begins.

Host issue, from the first pass: the host time from the second call's first
CUDA API call to the last call's last, less the time the API calls were
held, each one's time beyond the median time of the first pass's opening API
calls (issued into an empty queue, so never held), and less the tracer's own
buffer work.  The CUDA activity tracer slows the host's issue itself, so
host issue and the idle share read above their untraced values where the
host paces; ``readers.untraced_idle_share`` sets the traced busy time against
the untraced window's pace.

Both passes read the profiler's raw records (building its event tree for
tens of thousands of kernels takes minutes), and each ends with a 50 ms
settle (late records of a long run arrive after the card is done).
"""

from __future__ import annotations

import bisect
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

SPAN = "portbench.window"
OPENING_CALLS = 256          # the first pass's API calls that set the unheld time
TRACER = "Activity Buffer"   # the tracer's own host records


@dataclass
class Trace:
    window_s: float                          # the segment: the second call's first op to the end
    busy_s: float
    device_s: float                          # the sum of every device op's duration
    launches: int                            # kernels (copies and fills not counted)
    by_name: Dict[str, Tuple[int, float]]    # device op name → (count, seconds)
    host_issue_s: float = 0.0                # host time of the segment's calls, less holds
    host: dict = field(default_factory=dict)  # how host issue was read, printed to stderr
    gaps: List[list] = field(default_factory=list)

    def kernel_seconds(self, names) -> Tuple[int, float]:
        """(calls, seconds) of the kernels whose name holds one of ``names``."""
        n, s = 0, 0.0
        for k, (c, t) in self.by_name.items():
            if any(x in k for x in names):
                n, s = n + c, s + t
        return n, s

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[k[:64], t] for k, (_, t) in ops], "idle_gaps": self.gaps[:10]}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def profile(fn: Callable[[], object], calls: int, gap_calls: int = 2,
            settle_s: float = 0.05) -> Trace:
    """Trace ``calls`` calls of ``fn`` (CUDA activity), then ``gap_calls``
    calls (host and device) for the idle gaps; the first call of each pass is
    left out."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    if calls < 2 or gap_calls < 2:
        raise ValueError("a traced pass needs a call besides its first")
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(settle_s)
    trace = device_reduce(prof.profiler.kineto_results.events(), calls)
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            for _ in range(gap_calls):
                fn()
            torch.cuda.synchronize()
        time.sleep(settle_s)
    trace.gaps = idle_gaps(prof.profiler.kineto_results.events(), gap_calls)
    return trace


def _device_ops(raw, a=None, b=None) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.start_ns(), e.end_ns(), e.name()) for e in raw
           if e.device_type() == cuda and not e.is_user_annotation()]
    if a is not None:
        ops = [(s, min(t, b), n) for s, t, n in ops if a <= s <= b]
    return sorted(ops)


def _after_first(items: list, calls: int) -> list:
    """The items of every call but the first, the calls alike in count."""
    return items[len(items) // calls:]


def _union(ops) -> Tuple[int, list]:
    """(busy ns, [(gap start, gap end)] between the ops)."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, t, _ in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def device_reduce(raw, calls: int) -> Trace:
    events = list(raw)
    ops = _after_first(_device_ops(events), calls)
    if not ops:
        raise RuntimeError("the traced segment holds no device operation")
    by_name: Dict[str, Tuple[int, float]] = {}
    for s, t, name in ops:
        c, sec = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, sec + (t - s) / 1e9)
    busy, _ = _union(ops)
    trace = Trace(window_s=(max(t for _, t, _ in ops) - ops[0][0]) / 1e9, busy_s=busy / 1e9,
                  device_s=sum(t - s for s, t, _ in ops) / 1e9,
                  launches=sum(not _is_copy(n) for _, _, n in ops), by_name=by_name)
    trace.host_issue_s, trace.host = host_issue(events, calls)
    return trace


def host_issue(raw, calls: int) -> Tuple[float, dict]:
    """(host seconds of every call but the first, how they were read) from a
    CUDA-activity trace's host records: its CUDA API calls and the tracer's
    own work.  An API call nested in another (a driver call inside a runtime
    call) is part of the outer one."""
    cpu = torch.autograd.DeviceType.CPU
    host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in raw if e.device_type() == cpu)
    api, tracer, other, end = [], [], set(), -1
    for s, t, n in host:
        if n.startswith(TRACER):
            tracer.append((s, t, n))
        elif not n.startswith("cu"):
            other.add(n)
        elif t > end:                 # not inside the previous API call
            api.append((s, t, n))
            end = t
    waits = [x for x in api if "Synchronize" in x[2]]
    api = [x for x in api if "Synchronize" not in x[2]]
    if len(api) < 2 * calls:
        return 0.0, {"api_calls": len(api)}
    unheld = statistics.median(t - s for s, t, _ in api[:min(OPENING_CALLS, len(api) // calls)])
    seg = _after_first(api, calls)
    a, b = seg[0][0], max(t for _, t, _ in seg)
    held = sum(max(0, t - s - unheld) for s, t, _ in seg)
    held += sum(t - s for s, t, _ in waits if a <= s < b)
    own = sum(min(t, b) - max(s, a) for s, t, _ in tracer if s < b and t > a)
    names: Dict[str, int] = {}
    for _, _, n in seg:
        names[n] = names.get(n, 0) + 1
    read = {"span_s": (b - a) / 1e9, "held_s": held / 1e9, "tracer_s": own / 1e9,
            "unheld_us": unheld / 1e3, "api_calls": names,
            "other": sorted(other)[:5]}
    return (b - a - held - own) / 1e9, read


def idle_gaps(raw, calls: int, n: int = 10) -> List[list]:
    """The ``n`` longest gaps between device operations inside the traced host
    range, from the second call's first operation to the range's end, each
    [the host operation running at the gap's start, seconds]."""
    cpu = torch.autograd.DeviceType.CPU
    events = list(raw)
    span = [(e.start_ns(), e.end_ns()) for e in events
            if e.name() == SPAN and e.device_type() == cpu]
    if not span:
        return []
    a, b = span[0]
    ops = _after_first(_device_ops(events, a, b), calls)
    if not ops:
        return []
    _, gaps = _union(ops)
    gaps.append((max(t for _, t, _ in ops), b))
    host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                  if e.device_type() == cpu and not e.is_user_annotation()
                  and e.start_ns() <= b and e.end_ns() >= a)
    starts = [h[0] for h in host]

    def doing(at: int) -> str:
        i = bisect.bisect_right(starts, at) - 1
        for j in range(i, max(i - 2000, -1), -1):
            if host[j][1] >= at:
                return host[j][2]
        return "none"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    return [[doing(s), (t - s) / 1e9] for s, t in longest]
