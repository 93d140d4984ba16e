"""Training pairs a second: every pair of the window's steps over its whole time."""

def read(r):
    return r.rate
