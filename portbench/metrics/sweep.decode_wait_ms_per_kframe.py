"""ms of the ``sweep_decode_wait`` span a thousand frames, over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "sweep_decode_wait", "frames", 1e6)
