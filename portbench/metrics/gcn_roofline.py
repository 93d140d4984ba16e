"""The packed GCN kernel's share of its roofline, in %: its calls of a step at their bytes bound
(harness/flops.py) over the device time of the kernels named here.
"""

from harness.readers import roofline

KERNELS = ("gcn_packed",)


def read(r):
    return roofline(r, KERNELS, r.gcn_calls * r.gcn_bound_s)
