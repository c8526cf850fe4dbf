"""Stage spans, counters and device traces (counterpart of
``pywindow_tpu.profiling``).

Nothing is collected unless profiling is on: :func:`enable`, or
``PYWINDOW_TORCH_PROFILE=1`` in the environment.  Off, every span below
is one shared object that does nothing, no counter moves and no hook is
registered with the garbage collector.  On:

* ``stage(name, **ids)`` is a ``torch.profiler.record_function`` span
  named ``name`` that adds its host wall time to :data:`METRICS`; its
  ids, with those of the thread's current unit, label the span in the
  Chrome trace of :func:`trace`.  A stage's time includes waiting for
  the device only where the stage itself synchronises
  (``analysis_fetch``).  A span opened inside an open span of its own
  name on the same thread is not opened again, so no name's seconds
  count twice;
* the decorator ``entry_point(name, kind)`` makes each call of a public
  function a span (``analysis_batched``,
  ``analysis_batched_distributed``, ``full_analysis``, ``load_file``):
  it draws the call a new ``kind`` id (``sweep``, ``request``, ``load``)
  and makes it the thread's current unit, which every span opened
  inside carries; :func:`call` runs a function with ids added to the
  current unit (a sweep's ``chunk``, on its main, decoder and collector
  threads);
* each pass of the cyclic garbage collector is a ``gc`` span (its
  generation in the ids), booked as ``gc`` seconds and counted as
  ``gc_passes.gen<k>``;
* ``device_stage(name, device)`` times device work: between two CUDA
  events on the card, read when the caller settles the span after it
  has waited for the work anyway (the sweep's collector does, after the
  chunk's fetch), so the timer adds no synchronisation; a host span on
  the CPU.  A chunk sharded over several devices books one span, its
  busiest device's (:func:`settle_shards`);
* a sweep's re-runs of escalated frames are ``sweep_rerun`` spans
  whose id ``reason`` is the marker (``open_overflow``, ``budget``,
  ``window_sat``), inside ``sweep_retry``;
* :data:`METRICS` counts what the analysis feeds it: molecules analysed,
  windows found, refinements failed, re-runs by reason
  (``analysis_reruns.<reason>``, ``frames_retried.<reason>``), the
  frames a sweep held back from their chunks for its gathered
  full-budget re-run (``frames_budget_gathered``), the streamed
  sweep's restarts (``sweep_restarts``), the escalated caps a
  sweep stores for its later chunks and sweeps
  (``caps_learned.<field>``: ``open_cap_frac``, ``max_windows``), the
  frames of chunks dispatched at such learned caps
  (``frames_at_learned_caps``) and the distance tests of the periodic
  rebuild's native BFS (``rebuild_bfs_pairs``).

``trace(log_dir)`` records a ``torch.profiler`` trace of the CPU (every
thread, where the installed torch can) and, where there is a card, of
its kernels, written as a Chrome trace under ``log_dir`` with each
span's ids in its ``args``.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import functools
import gc
import itertools
import json
import os
import pathlib
import threading
import time

import torch


class Metrics:
    """Process-wide counters and stage timers (safe to feed from the
    sweep's decoder and collector threads, and from a collector pass
    that interrupts a caller holding the lock)."""

    def __init__(self) -> None:
        self.counters: collections.Counter = collections.Counter()
        self.stage_seconds: collections.defaultdict = (
            collections.defaultdict(float)
        )
        self.stage_calls: collections.Counter = collections.Counter()
        self._lock = threading.RLock()

    def count(self, name: str, value: float = 1) -> None:
        """Increment counter *name* by *value* (only while profiling is
        on)."""
        if not _ENABLED:
            return
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

#: the thread's current unit: the ids every span opened in it carries
_UNIT: contextvars.ContextVar[dict] = contextvars.ContextVar("pywindow_torch_unit", default={})
#: per thread: the names of its open spans, and its collector pass's span
_LOCAL = threading.local()
#: the next id of each unit kind
_NEXT: collections.defaultdict = collections.defaultdict(itertools.count)
#: (thread, name, ids) of every span opened while :func:`trace` records
_TRACE_LOG: list | None = None


def enable(on: bool = True) -> None:
    """Turn profiling on (or off with ``on=False``) for the process."""
    global _ENABLED
    _ENABLED = on
    _hook_gc(on)


def enabled() -> bool:
    """Whether profiling is on."""
    return _ENABLED


class _Off:
    """Every span while profiling is off: one shared object that does
    nothing."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> None:
        pass

    def settle(self) -> None:
        return None


_OFF = _Off()


def _open_names() -> set:
    names = getattr(_LOCAL, "names", None)
    if names is None:
        names = _LOCAL.names = set()
    return names


class _Span:
    """One :func:`stage` span (with ``kind``: an :func:`entry_point`'s)."""

    __slots__ = ("name", "ids", "kind", "rf", "t0", "token")

    def __init__(self, name: str, ids: dict | None, kind: str | None = None) -> None:
        self.name, self.ids, self.kind = name, ids, kind
        self.rf = None

    def __enter__(self) -> _Span:
        names = _open_names()
        if self.name in names:
            return self  # inside a span of its own name: that one books
        names.add(self.name)
        ids = _UNIT.get()
        if self.kind is not None:
            ids = {**ids, self.kind: next(_NEXT[self.kind])}
            self.token = _UNIT.set(ids)
        if self.ids:
            ids = {**ids, **self.ids}
        log = _TRACE_LOG
        if log is not None:
            log.append((threading.get_native_id(), self.name, ids))
        self.t0 = time.perf_counter()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.rf is None:
            return
        self.rf.__exit__(None, None, None)
        METRICS.add_stage(self.name, time.perf_counter() - self.t0)
        if self.kind is not None:
            _UNIT.reset(self.token)
        _open_names().discard(self.name)


def stage(name: str, **ids):
    """A span of pipeline stage ``name`` (see the module's docstring);
    the shared no-op unless profiling is on."""
    if not _ENABLED:
        return _OFF
    return _Span(name, ids)


def entry_point(name: str, kind: str):
    """Decorator: every call of the function is a span ``name`` whose
    spans carry a new ``kind`` id (with profiling on)."""

    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _ENABLED:
                return fn(*args, **kwargs)
            with _Span(name, None, kind):
                return fn(*args, **kwargs)

        return spanned

    return wrap


def current() -> dict:
    """The ids of the thread's current unit (empty unless profiling is
    on and a unit is set)."""
    return _UNIT.get()


def call(ids: dict, fn, *args):
    """``fn(*args)`` with ``ids`` added to the calling thread's current
    unit (a thread the caller hands work to takes its unit so)."""
    if not _ENABLED:
        return fn(*args)
    token = _UNIT.set({**_UNIT.get(), **ids})
    try:
        return fn(*args)
    finally:
        _UNIT.reset(token)


def _on_gc(phase: str, info: dict) -> None:
    """The collector's hook: a pass is a ``gc`` span on its thread."""
    if phase == "start":
        span = _Span("gc", {"gen": info["generation"]})
        span.__enter__()
        _LOCAL.gc = span
        return
    span = getattr(_LOCAL, "gc", None)
    if span is not None:
        _LOCAL.gc = None
        span.__exit__(None, None, None)
        METRICS.count(f"gc_passes.gen{info['generation']}")


def _hook_gc(on: bool) -> None:
    if on and _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    elif not on and _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


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


def device_stage(name: str | None, device: torch.device, book: bool = True):
    """A context manager timing the device work enqueued inside it, on
    the current CUDA stream (a host span on the CPU); its ``settle()``
    books the time into :data:`METRICS` (with ``book=False`` it only
    returns it, for :func:`settle_shards`).  The shared no-op unless
    profiling is on, or without a name."""
    if not _ENABLED or name is None:
        return _OFF
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


def _every_thread() -> dict:
    """``torch.profiler.profile`` arguments that record the CPU work of
    every thread, not only the caller's (none where torch cannot)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def _label(path: pathlib.Path, log: list) -> None:
    """Write each logged span's ids into the ``args`` of its event in
    the Chrome trace ``path``: the k-th span of a name opened on a
    thread is that thread's k-th event of the name."""
    wanted: dict = collections.defaultdict(list)
    for tid, name, ids in log:
        wanted[tid, name].append(ids)
    data = json.loads(path.read_text())
    seen: collections.Counter = collections.Counter()
    notes = [e for e in data.get("traceEvents", []) if e.get("cat") == "user_annotation"]
    for e in sorted(notes, key=lambda e: e.get("ts", 0)):
        key = (e.get("tid"), e.get("name"))
        got = wanted.get(key)
        if got is None:
            continue
        k = seen[key]
        seen[key] += 1
        if k < len(got) and got[k]:
            e.setdefault("args", {}).update(got[k])
    path.write_text(json.dumps(data))


@contextlib.contextmanager
def trace(log_dir: pathlib.Path | str):
    """Record a ``torch.profiler`` trace of the CPU and, where a card is
    available, of its kernels; written on exit as
    ``<log_dir>/trace-<pid>-<n>.json`` (Chrome trace format), each span
    labelled with its ids (profiling on)."""
    global _TRACE_LOG
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    outer = _TRACE_LOG
    with profile(activities=activities, **_every_thread()) as prof:
        log = _TRACE_LOG = []
        try:
            yield prof
        finally:
            _TRACE_LOG = outer
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    trace.calls += 1
    path = log_dir / f"trace-{os.getpid()}-{trace.calls}.json"
    prof.export_chrome_trace(str(path))
    if log:
        _label(path, log)


trace.calls = 0
atexit.register(_hook_gc, False)
if _ENABLED:
    _hook_gc(True)
