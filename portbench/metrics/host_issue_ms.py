"""Host milliseconds to issue a step (or scored batch) in the traced segment, less the time its
CUDA API calls were held by a full launch queue (harness/trace.py).
"""

from harness.readers import host_issue_ms


def read(r):
    return host_issue_ms(r)
