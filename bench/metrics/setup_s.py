"""Seconds from the process's start to the window's: imports, the data
platform, the weights, the kernels' load, the feed's start and the warm
steps (the check's own bookkeeping left out)."""


def read(r):
    return r.setup_s
