"""ms of the ``analysis_fetch`` span a request (the blocking fetch of the
packed row: waiting for the device, then the copy), over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "analysis_fetch", "structures", 1e3)
