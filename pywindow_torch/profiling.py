"""Stage timers and counters.

``stage(name)`` accumulates host wall time per pipeline stage into
:data:`METRICS` and labels the span for ``torch.profiler``.  A stage's
time includes waiting for the device only where the stage itself
synchronises (``analyze`` fetches its result inside the
``full_analysis`` stage).  :data:`METRICS` also holds the counters the
analysis feeds (molecules analysed, windows found, refinements failed).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


class Metrics:
    """Process-wide counters and stage timers."""

    def __init__(self) -> None:
        self.counters: collections.Counter = collections.Counter()
        self.stage_seconds: collections.defaultdict = (
            collections.defaultdict(float)
        )
        self.stage_calls: collections.Counter = collections.Counter()

    def count(self, name: str, value: float = 1) -> None:
        """Increment counter *name* by *value*."""
        self.counters[name] += value


METRICS = Metrics()


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage into :data:`METRICS`."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        METRICS.stage_seconds[name] += time.perf_counter() - t0
        METRICS.stage_calls[name] += 1
