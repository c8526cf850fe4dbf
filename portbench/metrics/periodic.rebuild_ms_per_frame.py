"""ms of the ``trajectory_rebuild`` span a frame, over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "trajectory_rebuild", "frames", 1e3)
