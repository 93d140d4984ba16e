"""The PMMA attention kernels' share of their roofline, in %: the attention calls of a step (or a
scored batch) at their bound (harness/flops.py) over the device time of the kernels named here.
"""

from harness.readers import roofline

KERNELS = ("attention_fwd", "attention_dq", "attention_dkv")


def read(r):
    return roofline(r, KERNELS, r.attn_bound_s)
