"""ms of the ``sweep_open`` span a thousand frames, over the span window:
the slab decoder's open and the sweep's set-up (host encode, lanes, the
pinned store)."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "sweep_open", "frames", 1e6)
