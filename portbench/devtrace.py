"""Reduction of a ``torch.profiler`` trace to what the result line
reports: the seconds in which an operation ran on the device (the union
of the device intervals inside the window), the kernels launched, the
device operations that took most time and the longest idle gaps (the
window's edges included), each named by the innermost program stage
span open at the gap's middle ("host" where none was).  The window is
the host annotation :data:`WINDOW` that the harness opens around the
traced units."""

from __future__ import annotations

import collections
import dataclasses

from torch.autograd import DeviceType

#: entries of each breakdown list
TOP = 10
#: the harness's annotation around the traced units
WINDOW = "portbench.window"


@dataclasses.dataclass
class DeviceTrace:
    """A traced window, reduced."""

    busy_s: float
    kernels: int
    device_ops: list
    idle_gaps: list


def _union(intervals: list[tuple[int, int]]) -> tuple[int, list[tuple[int, int]]]:
    """(covered ns, merged intervals) of (start, end) ns intervals."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def reduce(prof) -> DeviceTrace:
    """Reduce the profile ``prof`` of a window annotated :data:`WINDOW`."""
    device, notes, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append((start, start + dur, e.name()))
        elif e.is_user_annotation() and e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW:
                window = (start, start + dur)
            else:
                notes.append((start, start + dur, e.name()))
    if window is not None:
        lo, hi = window
        device = [(max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi]
    busy_ns, merged = _union([(s, e) for s, e, _ in device])
    by_name: collections.Counter = collections.Counter()
    for s, e, name in device:
        by_name[name] += e - s
    edges = merged
    if window is not None:
        edges = [(lo, lo), *merged, (hi, hi)]
    gaps = sorted(
        ((b[0] - a[1], a[1], b[0]) for a, b in zip(edges, edges[1:]) if b[0] > a[1]),
        reverse=True,
    )[:TOP]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        open_notes = [n for n in notes if n[0] <= mid <= n[1]]
        name = min(open_notes, key=lambda n: n[1] - n[0])[2] if open_notes else "host"
        idle.append([name, length * 1e-9])
    return DeviceTrace(
        busy_s=busy_ns * 1e-9,
        kernels=sum(1 for _, _, n in device if not _is_copy(n)),
        device_ops=[[n, t * 1e-9] for n, t in by_name.most_common(TOP)],
        idle_gaps=idle,
    )
