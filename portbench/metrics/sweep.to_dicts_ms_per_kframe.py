"""ms of the ``sweep_to_dicts`` span a thousand frames, over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "sweep_to_dicts", "frames", 1e6)
