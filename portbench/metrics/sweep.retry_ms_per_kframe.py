"""ms of the ``sweep_retry`` span a thousand frames, over the span window:
the scan for escalation markers and any re-runs.  0.0 where the program
opened ``sweep_open`` but not this span; None where it has neither span."""

from portbench.metrics._lib import per_unit


def read(r):
    got = per_unit(r, "sweep_retry", "frames", 1e6)
    if got is None and per_unit(r, "sweep_open", "frames", 1e6) is not None:
        return 0.0
    return got
