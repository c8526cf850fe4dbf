"""ms of the ``sweep_rerun`` span a thousand frames, over the span window:
the re-runs of escalated frames alone, of every reason, without the
marker scan that ``sweep_retry`` holds too.  None where the run opened
no such span: nothing re-ran, or the program spans no re-run."""

from portbench.metrics._lib import per_unit


def read(r):
    return per_unit(r, "sweep_rerun", "frames", 1e6)
