"""Helpers of the metric readers.  A reader ``read(readings)`` returns a
number, or None where the run has nothing for it to read; it never
returns 0 for a share of a roofline."""

from __future__ import annotations


def per_unit(readings: dict, span: str, unit: str, scale: float) -> float | None:
    """Seconds of stage span ``span`` over the span window, per ``unit``
    done in it, times ``scale`` (1e6 gives ms a thousand units)."""
    spans, done = readings.get("spans"), readings.get("span_units", {}).get(unit)
    if not spans or span not in spans or not done:
        return None
    return spans[span] * scale / done


def roofline(readings: dict, kernel: str) -> float | None:
    """100 x bound over device time of the kernel's recorded calls."""
    got = readings.get("rooflines", {}).get(kernel)
    if not got or got[1] <= 0:
        return None
    return 100.0 * got[0] / got[1]
