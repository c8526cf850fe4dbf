"""ms of the ``trajectory_map`` span a thousand frames, over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "trajectory_map", "frames", 1e6)
