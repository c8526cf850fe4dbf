"""Multi-process trajectory analysis over ``torch.distributed``
(counterpart of ``pywindow_tpu.parallel.distributed``).

Every rank

1. decodes ONLY its own contiguous frame shard (:func:`_shard_frames`)
   through the trajectory's decode-up-front route (the native threaded
   decoder; per frame where it cannot take the frames),
2. takes the sweep-wide sampling pin before any analysis: the largest
   maximum diameter over all ranks (``all_reduce`` MAX in float64),
3. sweeps its shard at that fixed pin on its device
   (:mod:`pywindow_torch.parallel.mesh`), each frame's escalations
   re-run frame by frame within its chunk and no learned caps read or
   written, so no decision depends on state another rank does not
   share, and
4. all-gathers its shard's packed result rows as one tensor
   (``all_gather``; ``packed_size(max_windows)`` values a frame) and the dicts
   of the few frames it re-ran (``all_gather_object``), and converts
   the other ranks' rows with the native converter, so every rank holds
   every frame.

The results equal the single-process ``analysis_batched`` over the same
frames.  Bootstrap with :func:`initialize` (``torchrun`` exports what it
reads); without it, or with one process, the sweep runs locally.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from pywindow_torch import native, profiling
from pywindow_torch.config import DEFAULT_CONFIG, AnalysisConfig
from pywindow_torch.ops.analysis import batch_sizes, packed_size, to_properties_dicts_bulk
from pywindow_torch.parallel import batch, mesh
from pywindow_torch.parallel.mesh import DeviceSpec, frame_devices
from pywindow_torch.profiling import stage

#: how long a rank waits at a barrier or in a collective for the others
#: (the first rank to build the kernels holds the rest for ~1 minute)
TIMEOUT = datetime.timedelta(minutes=30)

#: barrier sequence numbers by tag (a repeated sweep meets at new keys)
_BARRIER_SEQ: dict[str, int] = {}


def _in_group() -> bool:
    """Whether this process belongs to a process group (of any size:
    one rank still runs its collectives through the backend)."""
    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> torch.device:
    """Join the process group of a multi-process sweep; returns this
    rank's device.

    The arguments default to ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK``, as ``torchrun`` exports them; the group is set up over
    ``tcp://``.  The rank's device, which an unindexed ``"cuda"`` names
    from then on (:data:`~pywindow_torch.parallel.mesh.LOCAL_DEVICES`):
    with a card ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK``
    defaults to the rank), without one the CPU.
    ``backend`` defaults to ``"nccl"`` on a card and ``"gloo"`` on the
    CPU; ``"gloo"`` on a card serves ranks that share one card, which
    NCCL refuses.  ``"nccl"`` without a card raises.
    """
    if coordinator_address is None:
        port = os.environ.get("MASTER_PORT")
        if port is None:
            msg = "initialize: pass coordinator_address or set MASTER_ADDR/MASTER_PORT"
            raise ValueError(msg)
        coordinator_address = f"{os.environ.get('MASTER_ADDR', 'localhost')}:{port}"
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))

    if torch.cuda.is_available():
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        msg = "initialize: the nccl backend needs a CUDA card"
        raise RuntimeError(msg)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank,
        timeout=TIMEOUT,
    )
    if dev.type == "cuda":
        mesh.LOCAL_DEVICES[:] = [dev]

    # ranks that share a device split its memory budget (mesh.ranks_on)
    store = dist.distributed_c10d._get_default_store()
    key = f"pywindow_torch/ranks_on/{mesh.device_key(dev)}"
    store.add(key, 1)
    _store_barrier("initialize")
    mesh.RANKS_ON.clear()
    mesh.RANKS_ON[mesh.device_key(dev)] = store.add(key, 0)
    return dev


def _store_barrier(tag: str) -> None:
    """Block until every rank reaches this (sequenced) barrier, on the
    process group's key-value store: safe to enter with any skew within
    :data:`TIMEOUT`, as a collective might not be."""
    if not _in_group():
        return
    seq = _BARRIER_SEQ.get(tag, 0)
    _BARRIER_SEQ[tag] = seq + 1
    store = dist.distributed_c10d._get_default_store()
    key = f"pywindow_torch/barrier/{tag}/{seq}"
    if store.add(key, 1) == dist.get_world_size():
        store.set(f"{key}/open", "1")
    store.wait([f"{key}/open"], TIMEOUT)


def _build_barrier(tag: str, devices: list[torch.device]) -> None:
    """Build and load what the sweep runs (the CUDA kernels where a
    device is a card, the native library and the dict converter), then
    meet every rank at a store barrier: the first collective after it
    finds no rank still building (counterpart of ``_compile_barrier``,
    distributed.py:62-81)."""
    if any(d.type == "cuda" for d in devices):
        from pywindow_torch.ops import _cuda

        _cuda.load_extension()
    native.lib()
    native.fastprops()
    with stage("rank_barrier"):  # waiting for the slowest rank
        _store_barrier(tag)


def _shard_frames(todo: list[int], n_procs: int) -> list[list[int]]:
    """Contiguous equal-size frame shards, padded by repeating the last
    frame (contiguous so each rank reads one byte range)."""
    per = (len(todo) + n_procs - 1) // n_procs
    shards = []
    for p in range(n_procs):
        shard = todo[p * per : (p + 1) * per]
        if not shard:
            shard = [todo[-1]]
        shard = shard + [shard[-1]] * (per - len(shard))
        shards.append(shard)
    return shards


def _decode_shard(traj, frames: list[int], swap_atoms, forcefield):
    """``(elements, coordinates (F, N, 3) float64)`` of ``frames``
    only: the native decode-up-front route, else frame by frame."""
    uniform = traj._decode_uniform(frames, swap_atoms, forcefield)
    if uniform is not None:
        return uniform
    mols = [traj._get_frame(f, swap_atoms, forcefield).system_to_molecule() for f in frames]
    elements = np.asarray(mols[0].elements)
    if any(not np.array_equal(np.asarray(m.elements), elements) for m in mols):
        msg = "analysis_batched_distributed: the frames do not share one element list"
        raise ValueError(msg)
    return elements, np.stack([np.asarray(m.coordinates, np.float64) for m in mols])


def _max_over_ranks(value: float, device: torch.device) -> float:
    """The largest ``value`` over all ranks, reduced in float64 (on the
    rank's card under NCCL)."""
    if not _in_group():
        return value
    on = device if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([value], dtype=torch.float64, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _gather_rows(block: np.ndarray, redone: dict, device: torch.device) -> tuple[list, list]:
    """Every rank's packed rows (all ranks' blocks have one shape, since
    the shards are equal) and ``{shard position: dict}`` of the frames
    it re-ran: one ``all_gather`` of the rows (on the rank's card under
    NCCL) and one ``all_gather_object`` of the re-run dicts."""
    on = device if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.from_numpy(block).to(on)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    extra: list = [None] * len(parts)
    dist.all_gather_object(extra, redone)
    return [p.cpu().numpy() for p in parts], extra


def _rows_to_dicts(rows: np.ndarray, cfg: AnalysisConfig, redone: dict) -> list[dict]:
    """Another rank's final dicts from its packed rows: the native
    converter's dicts with the escalation markers dropped, as
    ``retry_saturated_windows`` leaves them, and the frames it re-ran
    replaced by its re-runs' dicts."""
    out = to_properties_dicts_bulk(rows, cfg.max_windows)
    for props in out:
        for key in ("_open_cap_overflow", "_opt_budget_exceeded", "_window_cap_saturated"):
            props.pop(key, None)
    for pos, props in redone.items():
        out[pos] = props
    return out


@profiling.entry_point("analysis_batched_distributed", "sweep")
def analysis_batched_distributed(
    traj,
    frames="all",
    swap_atoms: dict | None = None,
    forcefield: str | None = None,
    override: bool = False,
    reference_max_diameter: float | None = None,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    device: DeviceSpec | None = None,
    batch_size: int | None = None,
) -> tuple[float, tuple[int, int, int, int]] | None:
    """Whole-sweep analysis of ``traj``'s frames over every rank of the
    process group (counterpart of
    ``pywindow_tpu.parallel.distributed.analysis_batched_distributed``).

    Each rank decodes and analyses its own frame shard on ``device``
    (an unindexed ``"cuda"`` is the rank's card, see
    :func:`initialize` and
    :func:`~pywindow_torch.parallel.mesh.shard_devices`; the card unless
    the caller asks for the CPU),
    in chunks of ``batch_size`` frames (default: the largest
    memory-safe chunk); results for ALL frames land in
    ``traj.analysis_output`` on EVERY rank, with the schema of
    ``analysis_batched``.  The sampling pin is the maximum diameter over
    all ranks' frames unless ``reference_max_diameter`` is given, and
    ray paths cover that maximum, so every rank runs the same sizes.
    Frames already analysed are skipped unless ``override``; every rank
    must hold the same ``analysis_output`` on entry.  Returns the pin
    and the sizes, or None when there was nothing to do.
    """
    devices = frame_devices(device)
    world, rank = (dist.get_world_size(), dist.get_rank()) if _in_group() else (1, 0)

    todo = traj._resolve_frames(frames)
    if not override:
        todo = [f for f in todo if f not in traj.analysis_output]
    if not todo:
        return None

    shards = _shard_frames(todo, world)
    mine = shards[rank]
    with stage("trajectory_decode"):
        elements, coords = _decode_shard(traj, mine, swap_atoms, forcefield)
    with stage("sweep_max_diameters"):
        maxd = batch.frame_max_diameters(elements, coords, devices)
    _build_barrier("sweep", devices)
    with stage("rank_pin"):
        global_max = _max_over_ranks(float(maxd.max()), devices[0])
    ref = global_max if reference_max_diameter is None else float(reference_max_diameter)
    sizes = batch_sizes(ref, global_max, cfg)

    results: list = [None] * len(mine)
    chunks: list = []  # (positions, rows) of every chunk
    redone: dict = {}

    def on_rows(positions, rows, redo) -> None:
        chunks.append((positions, rows))
        redone.update({int(positions[i]): props for i, props in redo.items()})

    def on_batch(positions, res) -> None:
        for pos, props in zip(positions.tolist(), res):
            results[pos] = props

    batch.sweep_uniform(
        elements, coords, maxd, on_batch, cfg, batch_size, reference_max_diameter=ref,
        device=device, bound_max_diameter=global_max, learn_caps=False,
        on_rows=on_rows if world > 1 else None,
    )
    finals = [results]
    if world > 1:  # nothing moves for a group of one
        block = np.empty((len(mine), packed_size(cfg.max_windows)), chunks[0][1].dtype)
        for positions, rows in chunks:
            block[positions] = rows
        with stage("sweep_gather"):
            parts, extra = _gather_rows(block, redone, devices[0])
            finals = [
                results if r == rank else _rows_to_dicts(parts[r], cfg, extra[r])
                for r in range(world)
            ]
    if override:
        for f in todo:
            traj.analysis_output.pop(f, None)
    for shard, part in zip(shards, finals):
        for k, (frame, props) in enumerate(zip(shard, part)):
            if k > 0 and shard[k] == shard[k - 1]:
                continue  # the padding repeats the shard's last frame
            props.pop("molecular_weight", None)
            props["no_of_atoms"] = len(elements)
            traj.analysis_output.setdefault(frame, {})["0"] = props
    return ref, sizes
