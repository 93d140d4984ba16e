"""The whole step's share of the bf16 peak, in %: the model's FLOPs per pair (harness/flops.py)
times the window's pairs a second.
"""

from harness.readers import mfu


def read(r):
    return mfu(r)
