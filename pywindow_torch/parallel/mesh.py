"""Device helpers for frame-parallel analysis (counterpart of
``pywindow_tpu.parallel.mesh``).

Frames, and the molecules of a system, are independent: a batch splits
into contiguous equal shards, one per device, and each device runs the
pipeline over its shard.  Torch has no ``Mesh`` or ``NamedSharding``:
a list of indexed devices (:func:`frame_devices`) stands for the JAX
package's 1-D ``frames`` mesh, and :func:`shard_bounds` for the layout
that ``PartitionSpec("frames")`` gives a batch over it.  The JAX
package's ``replicated`` and ``host_batch_sharding`` have no object of
their own here: a replicated tensor is one copy per device, made where a
shard needs it, and the (hosts x frames) layout is a rank's contiguous
frame shard (``distributed._shard_frames``) split again by
:func:`shard_bounds` over the rank's devices (:func:`host_device_grid`).
"""

from __future__ import annotations

import socket
from collections.abc import Sequence

import torch

from pywindow_torch.config import resolve_device

#: one device, or several (a list or tuple) to shard over
DeviceSpec = torch.device | str | Sequence[torch.device | str]

#: ranks of the process group that run on each device, by
#: :func:`device_key`; filled by ``distributed.initialize`` and read by
#: the memory budget (:func:`ranks_on`)
RANKS_ON: dict[str, int] = {}
#: a rank's card, set by ``distributed.initialize``: what an unindexed
#: ``"cuda"`` names then (every local card when empty)
LOCAL_DEVICES: list[torch.device] = []


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its card index made explicit (the calling thread's
    current card for an unindexed ``cuda``): a tensor made on an
    unindexed ``cuda`` lands on the current card of whichever thread
    makes it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def frame_devices(device: DeviceSpec | None = None) -> list[torch.device]:
    """The devices ``device`` names, each indexed (counterpart of
    ``frame_mesh``, mesh.py:18-22; :func:`shard_devices` says which of
    them a batch runs on).

    ``None`` is the default device
    (:func:`~pywindow_torch.config.default_device`).  An unindexed
    ``"cuda"`` gives every local card (``cuda:0`` ...
    ``cuda:n-1``), or a rank's card (:data:`LOCAL_DEVICES`); ``"cuda:k"``
    or ``"cpu"`` gives that one device; a list or tuple passes through,
    each entry checked by
    :func:`~pywindow_torch.config.resolve_device` (a device may appear
    more than once: it then runs several shards; all of one type).
    Raises when a card is asked for and none is available."""
    if isinstance(device, (list, tuple)):
        if not device:
            msg = "frame_devices: empty device list"
            raise ValueError(msg)
        devices = [_indexed(resolve_device(d)) for d in device]
        if len({d.type for d in devices}) > 1:
            msg = f"frame_devices: shards need one device type, got {devices}"
            raise ValueError(msg)
        return devices
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if LOCAL_DEVICES:
            return list(LOCAL_DEVICES)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def shard_devices(device: DeviceSpec) -> list[torch.device]:
    """The devices a batch is sharded over: every device of
    :func:`frame_devices` for a device or a list the caller names; for
    an unindexed ``"cuda"`` the first of its cards only.  One process
    over four cards was slower than one card at every layout measured
    (PERF.md §6): each shard repeats the chunk's host enqueue while the
    sweep's host work is not split, so the default stays on one card;
    several cards are used as ranks, one a card
    (:mod:`pywindow_torch.parallel.distributed`), or by naming them."""
    devices = frame_devices(device)
    if isinstance(device, (list, tuple)) or resolve_device(device).index is not None:
        return devices
    return devices[:1]


def pad_batch_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` >= ``n`` (shard-evenly padding)."""
    return ((n + n_devices - 1) // n_devices) * n_devices


def shard_bounds(b_pad: int, n_devices: int) -> list[tuple[int, int]]:
    """``(lo, hi)`` of each device's shard of a ``b_pad``-frame batch:
    contiguous and equal, in device order (``b_pad`` a multiple of
    ``n_devices``, see :func:`pad_batch_to_devices`)."""
    if b_pad % n_devices:
        msg = f"shard_bounds: {b_pad} frames do not split evenly over {n_devices} devices"
        raise ValueError(msg)
    per = b_pad // n_devices
    return [(i * per, (i + 1) * per) for i in range(n_devices)]


def host_device_grid(devices: Sequence, n_hosts: int | None = None) -> list[list]:
    """The (hosts x local devices) grid of ``host_device_mesh``
    (mesh.py:40-61): row h holds the devices of process h, the devices
    that do not fill a row dropped.  ``n_hosts`` defaults to the process
    group's size (1 without one); a single process can pass it to fold
    its devices into a fake grid."""
    if n_hosts is None:
        dist = torch.distributed
        n_hosts = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    per_host = len(devices) // n_hosts
    return [list(devices[h * per_host : (h + 1) * per_host]) for h in range(n_hosts)]


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
