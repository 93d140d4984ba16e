"""What the metric readers (``metrics/<name>.py``) read: a run's ``Reading``,
and the arithmetic shared by several readers.  A reader that finds nothing to
read returns None, and the metric is left out of the run's line."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from harness.flops import PEAK_BF16_FLOPS
from harness.trace import Trace


@dataclass
class Reading:
    setup_s: float
    rate: float                     # pairs per second over the whole window
    steps_per_s: float              # steps (or batches) per second over the whole window
    flops_per_pair: float
    attn_bound_s: float             # the attention calls of a step, at their bound
    gcn_bound_s: float              # one packed-GCN call at its bound
    gcn_calls: int                  # packed-GCN calls a step
    steps_traced: int = 0           # the steps of the traced segment (its first call left out)
    trace: Optional[Trace] = None


def per_step(r: Reading, seconds: float) -> Optional[float]:
    return None if r.trace is None else seconds * 1e3 / r.steps_traced


def roofline(r: Reading, names, bound_s_per_step: float) -> Optional[float]:
    """The kernels' share of their roofline, in %: their least time over the
    traced steps over their measured device time.  None when no kernel of
    ``names`` ran."""
    if r.trace is None:
        return None
    calls, seconds = r.trace.kernel_seconds(names)
    if calls == 0 or seconds <= 0.0 or bound_s_per_step <= 0.0:
        return None
    return 100.0 * bound_s_per_step * r.steps_traced / seconds


def mfu(r: Reading) -> float:
    """The whole step's share of the card's bf16 peak, in %."""
    return 100.0 * r.flops_per_pair * r.rate / PEAK_BF16_FLOPS


def idle_share(r: Reading) -> Optional[float]:
    """The traced segment's share, in %, with no device operation running."""
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def untraced_idle_share(r: Reading) -> Optional[float]:
    """The untraced window's share, in %, with no device operation running:
    the traced segment's busy time a step at the window's steps a second."""
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.steps_traced * r.steps_per_s)


def host_issue_ms(r: Reading) -> Optional[float]:
    """Host milliseconds to issue a step, less the time its CUDA API calls were
    held by a full launch queue (``trace.host_issue``)."""
    if r.trace is None or r.trace.host_issue_s <= 0.0:
        return None
    return r.trace.host_issue_s * 1e3 / r.steps_traced
