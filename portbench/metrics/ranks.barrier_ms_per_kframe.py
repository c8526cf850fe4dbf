"""ms of rank 0's ``rank_barrier`` span a thousand frames (waiting at the
sweep's store barrier for the other ranks), over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "rank_barrier", "frames", 1e6)
