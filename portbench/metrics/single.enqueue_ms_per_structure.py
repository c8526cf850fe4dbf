"""ms of the ``analysis_enqueue`` span a request (the host enqueue of the
pipeline, every pass), over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "analysis_enqueue", "structures", 1e3)
