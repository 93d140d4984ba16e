"""The reduction of the program's phase ranges (``harness/spans.py``) and its
per-step reading, on hand-made profiler records of a host-and-device pass:
kernels go to the phase whose range launched them (by correlation id, not by
when they run), copies are timed but not counted, a range's host time leaves
out held launches, waits and the tracer's own work, an idle gap goes to the
phase that launched the operation ending it (a device clock shifted against
the host's moves nothing), host waits count only inside ranges, the first
call is left out (a device record lost from it shifts nothing), a kernel
timed after the window still counts, and the sums are divided by the steps;
a trace with no range reads None."""

import pytest
import torch

from harness import spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
US = 1000
MAIN, AUTOGRAD = 1, 2
# a quantity's name in a reading → (its field of ``Spans``, its scale)
QUANTITIES = {"span_host_ms": ("host_s", 1e3), "span_device_ms": ("device_s", 1e3),
              "span_launches": ("launches", 1.0), "span_idle_ms": ("idle_s", 1e3),
              "span_host_waits": ("host_waits", 1.0)}


class Event:
    def __init__(self, name, start_us, end_us, device=CPU, tid=MAIN, corr=0, annotation=False):
        self._n, self._s, self._e, self._d = name, start_us * US, end_us * US, device
        self._t, self._c, self._a = tid, corr, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c


def _range(name, start, end):
    return Event(f"druglamp.{name}", start, end, annotation=True)


def _launch(name, at, corr, device_start, device_end, tid=MAIN, held=0, shift=0):
    api = "cudaMemcpyAsync" if name.startswith("Memcpy") else "cudaLaunchKernel"
    return [Event(api, at, at + 5 + held, tid=tid, corr=corr),
            Event(name, device_start + shift, device_end + shift, CUDA, corr=corr)]


def _pass(steps=1, first_forward_us=200, ranges=True, held_us=0, shift_us=0):
    """Two calls of ``steps`` steps each inside the window.  A step: a gather
    (a kernel that runs only once the forward has begun, and a copy), a
    forward, a cls backward whose kernel and wait come from autograd's thread,
    an AdamW.  The first call's forward kernel runs ``first_forward_us``, the
    second's 100 µs; an ATen record shares the backward kernel's correlation
    id, and a synchronise follows each call outside any range.  The
    forward's launch is held ``held_us`` beyond the 5 µs of every other API
    call, and the device records are placed ``shift_us`` late."""
    ev, corr = [Event(trace.SPAN, 0, 20000, annotation=True)], 100
    for c in range(2):
        for j in range(steps):
            t = c * 10000 + j * 2000
            fwd = first_forward_us if c == 0 else 100
            if ranges:
                ev += [_range("gather", t, t + 100), _range("forward", t + 100, t + 500),
                       _range("backward.cls", t + 500, t + 900),
                       _range("optimizer.cls", t + 900, t + 990)]
            ev += _launch("gather_k", t + 10, corr, t + 300, t + 350, shift=shift_us)
            ev += _launch("Memcpy HtoD (Pinned -> Device)", t + 20, corr + 1, t + 200, t + 240,
                          shift=shift_us)
            ev += _launch("forward_k", t + 110, corr + 2, t + 350, t + 350 + fwd, held=held_us,
                          shift=shift_us)
            ev += _launch("backward_k", t + 510, corr + 3, t + 600, t + 800, tid=AUTOGRAD,
                          shift=shift_us)
            ev.append(Event("cudaStreamSynchronize", t + 520, t + 530, tid=AUTOGRAD, corr=corr + 4))
            ev.append(Event("aten::mm", t + 920, t + 930, corr=corr + 3))
            ev += _launch("adam_k", t + 910, corr + 5, t + 950, t + 1000, shift=shift_us)
            corr += 10
        ev.append(Event("cudaDeviceSynchronize", c * 10000 + 9000, c * 10000 + 9100,
                        corr=corr + 6))
    return ev


def _read(name, phases):
    """``<quantity>[.<phase>].<cell>`` a step, as ``spans.per_step`` reads it."""
    quantity, *rest = name.split(".")
    field, scale = QUANTITIES[quantity]
    return spans.per_step(phases, field, rest[0] if len(rest) == 2 else None, scale)


def test_kernels_go_to_the_range_that_launched_them():
    s = spans.reduce(_pass(), calls=2)
    assert s.steps == 1 and s.launches == {"gather": 1, "forward": 1, "backward": 1,
                                           "optimizer": 1}
    # the gather's kernel ran inside the forward's range, the backward's was
    # launched from another thread, an ATen record shares its correlation id
    assert s.device_s["gather"] == pytest.approx((50 + 40) * 1e-6)
    assert s.device_s["backward"] == pytest.approx(200e-6)
    assert s.device_s["optimizer"] == pytest.approx(50e-6)
    # the backward's host time less its wait
    assert s.host_s == pytest.approx({"gather": 100e-6, "forward": 400e-6, "backward": 390e-6,
                                      "optimizer": 90e-6})


@pytest.mark.parametrize("held_us", [0, 40, 300])
def test_a_held_launch_and_the_tracers_work_leave_the_host_time(held_us):
    # only the forward launch's time beyond the opening calls' median (5 µs) is
    # a hold; the tracer's buffer work overlaps the forward's range by 30 µs
    # and the backward's by 10
    tracer = [Event(trace.TRACER + " flush", 10470, 10510, tid=3)]
    s = spans.reduce(_pass(held_us=held_us) + tracer, calls=2)
    assert s.host_s["forward"] == pytest.approx((400 - held_us - 30) * 1e-6)
    assert s.host_s["backward"] == pytest.approx(380e-6)
    assert s.host_s["gather"] == pytest.approx(100e-6)


def test_copies_are_timed_but_not_counted():
    phases = spans.reduce(_pass(), calls=2)
    assert _read("span_launches.gather.full", phases) == 1.0
    assert _read("span_device_ms.gather.full", phases) == pytest.approx(0.09)


@pytest.mark.parametrize("shift_us", [-300, 0, 2500, 7000])
def test_an_idle_gap_goes_to_the_phase_that_launched_its_end(shift_us):
    s = spans.reduce(_pass(shift_us=shift_us), calls=2)
    # 240–300 µs ends at the gather's kernel, 450–600 at the backward's, 800–950
    # at the AdamW's; the gap before the segment's first operation, and the
    # tail to the window's end, go to none
    assert s.idle_s == pytest.approx({"gather": 60e-6, "forward": 0.0, "backward": 150e-6,
                                      "optimizer": 150e-6})
    assert s == spans.reduce(_pass(), calls=2)


def test_host_waits_count_only_inside_ranges():
    s = spans.reduce(_pass(steps=2), calls=2)
    assert s.host_waits == 2                 # the backward's, not the calls' closing syncs
    assert _read("span_host_waits.full", s) == 1.0


@pytest.mark.parametrize("first_forward_us", [100, 150, 200])
def test_the_first_call_is_left_out(first_forward_us):
    s = spans.reduce(_pass(first_forward_us=first_forward_us), calls=2)
    assert s.device_s["forward"] == pytest.approx(100e-6)


def test_device_records_lost_from_the_first_call_move_nothing():
    whole = spans.reduce(_pass(), calls=2)
    lost = [e for e in _pass() if not (e.device_type() == CUDA and e.start_ns() < 10000 * US
                                       and e.name() in ("gather_k", "forward_k"))]
    assert spans.reduce(lost, calls=2) == whole


def test_a_kernel_timed_after_the_window_still_counts():
    late = [Event(e.name(), 20500, 20550, CUDA, corr=e.correlation_id())
            if e.name() == "adam_k" and e.start_ns() > 10000 * US else e for e in _pass()]
    s = spans.reduce(late, calls=2)
    assert s.launches["optimizer"] == 1 and s.device_s["optimizer"] == pytest.approx(50e-6)


def test_sums_are_divided_by_the_steps():
    one, two = spans.reduce(_pass(steps=1), calls=2), spans.reduce(_pass(steps=2), calls=2)
    assert two.steps == 2 and two.launches["forward"] == 2
    for metric in ("span_host_ms.forward.full", "span_device_ms.backward.cls",
                   "span_launches.optimizer.eval", "span_idle_ms.backward.full"):
        assert _read(metric, two) == pytest.approx(_read(metric, one))
    assert _read("span_host_ms.forward.full", two) == pytest.approx(0.4)


def test_a_trace_without_ranges_reads_none():
    assert spans.reduce(_pass(ranges=False), calls=2) is None
    assert spans.reduce([e for e in _pass() if e.name() != trace.SPAN], calls=2) is None
    for metric in ("span_host_ms.gather.full", "span_launches.backward.cls",
                   "span_idle_ms.optimizer.full", "span_host_waits.eval"):
        assert _read(metric, None) is None
    # a phase the cell does not run
    s = spans.reduce([e for e in _pass() if "optimizer" not in e.name()], calls=2)
    assert _read("span_device_ms.optimizer.full", s) is None
