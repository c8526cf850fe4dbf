"""ms of the ``analysis_rerun`` span a request (the escalated passes), over
the span window.  0.0 where the program opened ``analysis_enqueue``
but not this span (nothing re-ran); None where it has neither span."""

from portbench.metrics._lib import per_unit


def read(r):
    got = per_unit(r, "analysis_rerun", "structures", 1e3)
    if got is None and per_unit(r, "analysis_enqueue", "structures", 1e3) is not None:
        return 0.0
    return got
