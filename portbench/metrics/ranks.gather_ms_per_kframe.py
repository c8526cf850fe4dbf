"""ms of rank 0's ``sweep_gather`` span a thousand frames, over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "sweep_gather", "frames", 1e6)
