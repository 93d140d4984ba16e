"""The untraced window's share, in %, in which no operation ran on the device: the traced
segment's device busy time a step against the window's steps a second.
"""

from harness.readers import untraced_idle_share


def read(r):
    return untraced_idle_share(r)
