"""The traced segment's share, in %, in which no operation ran on the device (harness/trace.py:
the first traced call left out; the tracer slows the host, so where the host paces this reads
above the untraced share).
"""

from harness.readers import idle_share


def read(r):
    return idle_share(r)
