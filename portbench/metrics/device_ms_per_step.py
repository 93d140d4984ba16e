"""Device milliseconds per step (or scored batch): every device operation of the traced segment."""

from harness.readers import per_step


def read(r):
    return None if r.trace is None else per_step(r, r.trace.device_s)
