"""The one helper of the port's kernel module that the plain versions
use (frozen copy of ``pywindow_torch/ops/_cuda.py:on_active_lanes``)."""

from __future__ import annotations

import torch


def on_active_lanes(active, fn, lane_args: tuple, placeholders: tuple) -> tuple:
    """``fn(*lane_args)`` on the lanes where ``active`` is True, scattered
    into ``placeholders``; every lane when ``active`` is None."""
    if active is None:
        return fn(*lane_args)
    idx = torch.nonzero(active).flatten()
    if idx.numel():
        for full, part in zip(placeholders, fn(*(a[idx] for a in lane_args))):
            full[idx] = part
    return placeholders
