"""Stage timers, counters and device traces (counterpart of
``pywindow_tpu.profiling``).

Nothing is collected unless profiling is on: :func:`enable`, or
``PYWINDOW_TORCH_PROFILE=1`` in the environment.  Then

* ``stage(name)`` accumulates host wall time per pipeline stage into
  :data:`METRICS` and labels the span for ``torch.profiler``; a stage's
  time includes waiting for the device only where the stage itself
  synchronises (``analyze`` fetches its result inside the
  ``full_analysis`` stage);
* ``device_stage(name, device)`` times device work: between two CUDA
  events on the card, read when the caller settles the span after it
  has waited for the work anyway (the sweep's collector does, after the
  chunk's fetch), so the timer adds no synchronisation; a host span on
  the CPU.  A chunk sharded over several devices books one span, its
  busiest device's (:func:`settle_shards`).

:data:`METRICS` also holds the counters the analysis feeds (molecules
analysed, windows found, refinements failed), which count whether or
not profiling is on.  ``trace(log_dir)`` records a ``torch.profiler``
trace of the CPU and, where there is a card, of its kernels, written as
a Chrome trace under ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import pathlib
import threading
import time

import torch


class Metrics:
    """Process-wide counters and stage timers (safe to feed from the
    sweep's decoder and collector threads)."""

    def __init__(self) -> None:
        self.counters: collections.Counter = collections.Counter()
        self.stage_seconds: collections.defaultdict = (
            collections.defaultdict(float)
        )
        self.stage_calls: collections.Counter = collections.Counter()
        self._lock = threading.Lock()

    def count(self, name: str, value: float = 1) -> None:
        """Increment counter *name* by *value*."""
        with self._lock:
            self.counters[name] += value

    def add_stage(self, name: str, seconds: float) -> None:
        """Add one call of stage *name* that took *seconds*."""
        with self._lock:
            self.stage_seconds[name] += seconds
            self.stage_calls[name] += 1

    def snapshot(self) -> dict:
        """Copy of all counters and stage timings."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "stage_seconds": dict(self.stage_seconds),
                "stage_calls": dict(self.stage_calls),
            }

    def reset(self) -> None:
        """Clear all counters and stage timings."""
        with self._lock:
            self.counters.clear()
            self.stage_seconds.clear()
            self.stage_calls.clear()


METRICS = Metrics()
_ENABLED = os.environ.get("PYWINDOW_TORCH_PROFILE", "") == "1"


def enable(on: bool = True) -> None:
    """Turn stage timing on (or off with ``on=False``) for the process."""
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    """Whether stage timing is on."""
    return _ENABLED


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage into :data:`METRICS` (no-op unless
    profiling is on)."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        METRICS.add_stage(name, time.perf_counter() - t0)


class _DeviceSpan:
    """One :func:`device_stage` span; :meth:`settle` books it."""

    def __init__(self, name: str, cuda: bool, book: bool) -> None:
        self.name = name
        self.cuda = cuda
        self.book = book
        self.seconds: float | None = None

    def __enter__(self) -> _DeviceSpan:
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.cuda:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()
        else:
            self.seconds = time.perf_counter() - self.t0
            if self.book:
                METRICS.add_stage(self.name, self.seconds)

    def settle(self) -> float:
        """The span's device time, booked unless the span was opened with
        ``book=False`` (waits for its end event; call it where the work
        has been waited for already)."""
        if self.cuda and self.seconds is None:
            self.end.synchronize()
            self.seconds = self.start.elapsed_time(self.end) * 1e-3
            if self.book:
                METRICS.add_stage(self.name, self.seconds)
        return self.seconds


class _NoSpan:
    def __enter__(self) -> _NoSpan:
        return self

    def __exit__(self, *exc) -> None:
        pass

    def settle(self) -> None:
        return None


def device_stage(name: str | None, device: torch.device, book: bool = True):
    """A context manager timing the device work enqueued inside it, on
    the current CUDA stream (a host span on the CPU); its ``settle()``
    books the time into :data:`METRICS` (with ``book=False`` it only
    returns it, for :func:`settle_shards`).  No-op unless profiling is
    on, or without a name."""
    if not _ENABLED or name is None:
        return _NoSpan()
    return _DeviceSpan(name, torch.device(device).type == "cuda", book)


def settle_shards(name: str, shards) -> None:
    """Book one chunk's device time as one ``name`` span from its
    shards' ``(device, span)`` pairs (spans opened with ``book=False``):
    the shards of one device run one after another and the devices at
    once, so the chunk took its busiest device's sum.  With one shard
    this is that shard's span."""
    per_device: dict = {}
    for dev, span in shards:
        seconds = span.settle()
        if seconds is None:
            return  # opened with profiling off
        per_device[dev] = per_device.get(dev, 0.0) + seconds
    if per_device:
        METRICS.add_stage(name, max(per_device.values()))


@contextlib.contextmanager
def trace(log_dir: pathlib.Path | str):
    """Record a ``torch.profiler`` trace of the CPU and, where a card is
    available, of its kernels; written on exit as
    ``<log_dir>/trace-<pid>-<n>.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    trace.calls += 1
    prof.export_chrome_trace(str(log_dir / f"trace-{os.getpid()}-{trace.calls}.json"))


trace.calls = 0
