"""ms of the program's ``load_file`` span a request, over the span window."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "load_file", "structures", 1e3)
