"""The reduction of a trace to the per-layer numbers (``harness/trace.py``), on
hand-made profiler records: the first traced call is left out, the device's
busy time and window are those of the calls after it, and host issue is the
host's time less what the launch queue and the tracer held it."""

import pytest
import torch

from harness import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
US = 1000


class Event:
    def __init__(self, name, start_us, end_us, device):
        self._n, self._s, self._e, self._d = name, start_us * US, end_us * US, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return False


def _two_calls(held_us):
    """Two calls of three launches and three 100 µs kernels each.  The first
    call issues into an empty queue (5 µs a launch); each launch of the second
    is held ``held_us`` more, and the card runs its kernels back to back."""
    ev, t = [], 0
    for i in range(3):                          # call 1: the host ahead of nothing
        ev.append(Event("cudaLaunchKernel", t, t + 5, CPU))
        ev.append(Event("cuLaunchKernel", t + 1, t + 4, CPU))     # nested: not counted twice
        ev.append(Event(f"k{i}", t + 10, t + 110, CUDA))
        t += 200
    ev.append(Event("Activity Buffer Request", t, t + 50, CPU))
    start = 1000
    for i in range(3):                          # call 2: held by a full queue
        s = start + i * (5 + held_us)
        ev.append(Event("cudaLaunchKernel", s, s + 5 + held_us, CPU))
        ev.append(Event(f"k{i}", 1100 + 100 * i, 1200 + 100 * i, CUDA))
    ev.append(Event("cudaDeviceSynchronize", 1400, 1401, CPU))
    return ev


@pytest.mark.parametrize("held_us", [0, 80])
def test_the_second_call_is_measured_and_holds_are_left_out(held_us):
    t = trace.device_reduce(_two_calls(held_us), calls=2)
    assert t.launches == 3 and t.by_name["k0"] == (1, pytest.approx(100e-6))
    assert t.window_s == pytest.approx(300e-6) and t.busy_s == pytest.approx(300e-6)
    # call 2's host span, less each launch's time beyond the unheld 5 µs
    assert t.host_issue_s == pytest.approx(3 * 5e-6)
    assert t.host["held_s"] == pytest.approx(3 * held_us * 1e-6)


def test_the_tracers_own_work_and_waits_are_not_host_issue():
    ev = [Event("cudaLaunchKernel", 200 * i, 200 * i + 5, CPU) for i in range(4)]
    ev += [Event(f"k{i}", 200 * i + 10, 200 * i + 20, CUDA) for i in range(4)]
    ev.append(Event("Activity Buffer Request", 450, 500, CPU))
    ev.append(Event("cudaStreamSynchronize", 520, 560, CPU))
    t = trace.device_reduce(ev, calls=2)
    # call 2: launches at 400 and 600, span 400–605, less the tracer and the wait
    assert t.host_issue_s == pytest.approx((205 - 50 - 40) * 1e-6)
    assert t.window_s == pytest.approx(210e-6) and t.busy_s == pytest.approx(20e-6)


def test_a_trace_without_api_records_reads_no_host_issue():
    ev = [Event(f"k{i}", 10 * i, 10 * i + 5, CUDA) for i in range(4)]
    t = trace.device_reduce(ev, calls=2)
    assert t.host_issue_s == 0.0 and t.busy_s == pytest.approx(10e-6)
