"""ms of the ``sweep_dispatch`` span a thousand frames, over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "sweep_dispatch", "frames", 1e6)
