"""Kernels launched per step (or scored batch) in the traced segment (copies and fills not
counted)."""

def read(r):
    return None if r.trace is None else r.trace.launches / r.steps_traced
