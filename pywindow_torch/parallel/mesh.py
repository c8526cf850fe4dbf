"""The device of frame-parallel analysis (counterpart of
``pywindow_tpu.parallel.mesh``).

Frames, and the molecules of a system, are independent.  One process
runs its batches on one device (:func:`frame_device`); several cards run
as ranks of a process group, one a card, each over its own contiguous
frame shard (:mod:`pywindow_torch.parallel.distributed`), which takes
the place of the JAX package's (hosts x frames) mesh.  One process over
several cards was slower than one card at every layout measured on
H100s, and four ranks, one a card, beat both (PERF.md §6).
"""

from __future__ import annotations

import socket

import torch

from pywindow_torch.config import resolve_device

#: one device: a ``torch.device`` or its name
DeviceSpec = torch.device | str

#: ranks of the process group that run on each device, by
#: :func:`device_key`; filled by ``distributed.initialize`` and read by
#: the memory budget (:func:`ranks_on`)
RANKS_ON: dict[str, int] = {}
#: a rank's card, set by ``distributed.initialize``: what an unindexed
#: ``"cuda"`` names then (``cuda:0`` while it is None)
LOCAL_DEVICE: torch.device | None = None


def frame_device(device: DeviceSpec | None = None) -> torch.device:
    """The one indexed device ``device`` names (counterpart of
    ``frame_mesh``, mesh.py:18-22).

    ``None`` is the default device
    (:func:`~pywindow_torch.config.default_device`).  An unindexed
    ``"cuda"`` is the rank's card (:data:`LOCAL_DEVICE`), else
    ``cuda:0``; ``"cuda:k"`` or ``"cpu"`` is that device.  Raises
    ``ValueError`` for a list or tuple (one process runs on one device),
    and ``RuntimeError`` when a card is asked for and none is
    available."""
    if isinstance(device, (list, tuple)):
        msg = (
            f"pywindow_torch: device={device!r}: one process runs on one device; "
            "run several cards as ranks, one a card (pywindow_torch.parallel.distributed)"
        )
        raise ValueError(msg)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return LOCAL_DEVICE if LOCAL_DEVICE is not None else torch.device("cuda", 0)
    return dev


def device_key(dev: torch.device) -> str:
    """A key naming one physical device across processes: the card's
    UUID, or the host's name for the CPU."""
    if dev.type == "cuda":
        return str(torch.cuda.get_device_properties(dev).uuid)
    return f"{socket.gethostname()}:{dev.type}"


def ranks_on(dev: torch.device) -> int:
    """Ranks of the process group that run on ``dev`` (1 outside one)."""
    if not RANKS_ON:
        return 1
    return RANKS_ON.get(device_key(dev), 1)
