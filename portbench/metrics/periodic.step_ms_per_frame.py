"""ms of the ``sweep_step`` span (device time) a frame, over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "sweep_step", "frames", 1e3)
