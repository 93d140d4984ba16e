"""Set-up seconds: process start to the window, loading, building, the checked steps and the
warm-up included.
"""

def read(r):
    return r.setup_s
