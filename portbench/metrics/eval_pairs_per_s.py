"""Library pairs scored a second: every pair of every pass of the window over its whole time."""

def read(r):
    return r.rate
