"""Batched full analysis over many frames or molecules (counterpart of
``pywindow_tpu.parallel.batch``).

A chunk of B molecules runs the whole pipeline as one batch with a
leading frame axis (:func:`pywindow_torch.ops.analysis.run_pipeline`):
each kernel sees all of the chunk's frames in one launch, so the number
of launches per chunk does not depend on B.  ``device`` names one device
or several (:func:`~pywindow_torch.parallel.mesh.frame_devices`: an
unindexed ``"cuda"`` is every local card); over several, a chunk is
padded to a multiple of the device count with copies of its first
system, split into contiguous equal shards, and every shard runs the
pipeline with the same static sizes on its own device, the padding
sliced off on collect.  Chunks are sized to the devices' free memory by
:func:`max_safe_batch`.  A sweep over frames of
one element list (:func:`sweep_stream`, :func:`sweep_uniform`) decodes
slab k+1 on a thread while the device runs chunk k, moves each chunk's
coordinates from pinned host slabs on a side stream, and fetches and
converts its results on a collector thread.  Molecules whose run
outgrew a static cap, or an optimiser's fast budget, re-run escalated
(:func:`retry_saturated_windows`), a sweep's fast-budget frames in one
batch after its last chunk; a sweep whose chunks mostly escalate
opens later chunks, and later sweeps of the same system, at the
escalated caps (:data:`LEARNED_CAPS`).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pywindow_torch import profiling, tables
from pywindow_torch.config import (
    DEFAULT_CONFIG,
    MAX_WINDOWS_CEILING,
    AnalysisConfig,
    default_dtype,
    pad_multiple,
)
from pywindow_torch.ops import analysis as _analysis
from pywindow_torch.ops.analysis import (
    batch_sizes,
    max_dim_bound,
    static_sizes,
    to_properties_dicts_bulk,
)
from pywindow_torch.ops.encoding import (
    FAR_AWAY,
    MolArrays,
    encode_batch,
    encode_host,
    numpy_dtype,
    round_up,
)
from pywindow_torch.ops.geometry import pairwise_distances
from pywindow_torch.ops.ray_kernels import MAX_FRAMES
from pywindow_torch.ops.windows import open_cap
from pywindow_torch.parallel.mesh import (
    DeviceSpec,
    frame_devices,
    pad_batch_to_devices,
    ranks_on,
    shard_bounds,
    shard_devices,
)
from pywindow_torch.profiling import METRICS, stage

logger = logging.getLogger("pywindow_torch")

#: working-memory budget of a batch on the CPU (the card's budget is
#: read from the card: see :func:`memory_budget`)
HOST_BUDGET_BYTES = 2 * 1024**3
#: share of the card's free memory a chunk may plan to use
CARD_BUDGET_SHARE = 0.8


class LearnedCaps:
    """Escalated configs learned per (system, padded atoms, base config),
    bounded to ``limit`` entries with the oldest evicted first (the JAX
    package cleared the whole store when it filled)."""

    def __init__(self, limit: int = 32) -> None:
        self.limit = limit
        self._caps: collections.OrderedDict = collections.OrderedDict()

    def get(self, key, default: AnalysisConfig) -> AnalysisConfig:
        return self._caps.get(key, default)

    def put(self, key, cfg: AnalysisConfig) -> None:
        self._caps[key] = cfg
        self._caps.move_to_end(key)
        while len(self._caps) > self.limit:
            self._caps.popitem(last=False)

    def __len__(self) -> int:
        return len(self._caps)


#: the process's learned cap escalations (see :class:`LearnedCaps`)
LEARNED_CAPS = LearnedCaps()


def memory_budget(device: torch.device) -> int:
    """Bytes a batch may plan to use: a share of the card's free memory,
    or :data:`HOST_BUDGET_BYTES` on the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(CARD_BUDGET_SHARE * free)
    return HOST_BUDGET_BYTES


def frame_bytes(
    n_pad: int, n_win: int, k: int, l1: int, max_windows: int, device_type: str
) -> int:
    """Peak working bytes per frame of the device pipeline.

    On the card: the (N, N, 3) pairwise differences of the maximum
    diameter with their (N, N) reductions (~48 N^2 bytes in float32),
    the window lanes' rotated float64 molecules and their temporaries
    (~160 W N), and the DBSCAN adjacency bitmask.  The plain ray sweeps
    of the CPU also materialise (rays, steps, atoms, 3) float64 blocks.
    """
    card = 48 * n_pad * n_pad + 160 * max_windows * n_pad + k * k
    if device_type == "cuda":
        return card
    return card + 32 * k * l1 * n_pad + 64 * n_win * n_pad + 32 * k * k


def max_safe_batch(
    n_atoms: int,
    max_diameter: float,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    device: DeviceSpec | None = None,
    budget: int | None = None,
) -> int:
    """Largest batch whose working memory (:func:`frame_bytes`) fits the
    devices' budgets, with at most the frames one ray-kernel launch takes
    (:data:`~pywindow_torch.ops.ray_kernels.MAX_FRAMES`) on each device.

    Over several devices the batch splits into one equal shard a device;
    a device's budget (:func:`memory_budget` unless ``budget`` is given)
    is split between the shards it runs and the ranks of the process
    group that run on it (:func:`~pywindow_torch.parallel.mesh.ranks_on`),
    since each of them would otherwise plan with all of its memory (the
    devices of :func:`~pywindow_torch.parallel.mesh.shard_devices`)."""
    devices = shard_devices(device)
    n_pad = round_up(max(n_atoms, 1), pad_multiple())
    n_win, _, l1, _ = static_sizes(max_diameter, cfg)
    k = open_cap(n_win, cfg.open_cap_frac) or n_win
    per_frame = frame_bytes(n_pad, n_win, k, l1, cfg.max_windows, devices[0].type)
    per_shard = MAX_FRAMES
    for dev in set(devices):
        total = memory_budget(dev) if budget is None else budget
        sharers = devices.count(dev) * ranks_on(dev)
        per_shard = min(per_shard, int(total // sharers // per_frame))
    return max(1, per_shard) * len(devices)


def chunk_plan(n_frames: int, c: int) -> list[tuple[int, int]]:
    """``(lo, hi)`` frame ranges of at most ``c`` frames.  (The JAX
    package padded every chunk to a few compiled shapes; eager PyTorch
    compiles nothing, so the last chunk simply runs short.)"""
    return [(lo, min(lo + c, n_frames)) for lo in range(0, n_frames, c)]


def frame_max_diameters(elements: np.ndarray, coords: np.ndarray, device: DeviceSpec) -> np.ndarray:
    """Exact vdW-corrected maximum diameter of every frame (F, N, 3) of
    one element list, in float64 on ``device`` (the first of several;
    chunked by memory); the sweep pins its sampling sizes from these."""
    device = frame_devices(device)[0]
    vdw = torch.as_tensor(
        tables.ELEMENT_VDW[tables.element_ids(elements)], dtype=torch.float64,
        device=device,
    )
    n = coords.shape[1]
    step = max(1, int(2**28 // (24 * max(n, 1) ** 2)))
    out = np.empty(len(coords), dtype=np.float64)
    for lo in range(0, len(coords), step):
        c = torch.as_tensor(coords[lo : lo + step], dtype=torch.float64, device=device)
        d = pairwise_distances(c, c) + vdw[:, None] + vdw[None, :]
        out[lo : lo + step] = d.amax((-2, -1)).cpu().numpy()
    return out


def _largest_exact_maxd(systems, device: DeviceSpec) -> float:
    """Exact maximum diameter of the largest member of ``systems``,
    computed on ``device`` (the first of several) in float64 chunks."""
    device = frame_devices(device)[0]
    best = 0.0
    for lo in range(0, len(systems), 256):
        part = systems[lo : lo + 256]
        mols = encode_batch(part, dtype=torch.float64, device=device)
        d = pairwise_distances(mols.coords, mols.coords)
        d = d + mols.vdw[..., :, None] + mols.vdw[..., None, :]
        valid = mols.mask[..., :, None] & mols.mask[..., None, :]
        best = max(best, float(torch.where(valid, d, -1e30).amax()))
    return best


def _on_shards(devices: list[torch.device], fn) -> list:
    """``fn(i, devices[i])`` for every shard i, in turn from the calling
    thread (a thread a shard was slower on one card and on four: PERF.md
    §6).  On the card each call runs with its device current and
    on the calling thread's stream of that device."""
    if devices[0].type != "cuda":
        return [fn(i, dev) for i, dev in enumerate(devices)]
    out = []
    for i, dev in enumerate(devices):
        with torch.cuda.stream(torch.cuda.current_stream(dev)):  # makes dev current too
            out.append(fn(i, dev))
    return out


def dispatch_batch(
    systems: list[tuple[np.ndarray, np.ndarray]],
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    reference_max_diameter: float | None = None,
    pad_atoms: int | None = None,
    device: DeviceSpec | None = None,
    span: str | None = None,
):
    """Encode one batch and queue its device pipeline; returns a handle
    for :func:`collect_batch` (the work runs asynchronously on the card
    until the collect fetches it).

    The static sizes cover the largest member: ray paths from the
    batch's bound, sampling counts from ``reference_max_diameter``
    (default: the batch's exact largest maximum diameter, reduced on the
    first device).  Over several devices
    (:func:`~pywindow_torch.parallel.mesh.shard_devices`) every shard
    takes these sizes and the batch's atom padding: no shard sizes
    itself.  ``span``: a device span of that name for the batch, booked
    by the collect (:func:`~pywindow_torch.profiling.settle_shards`).
    """
    b = len(systems)
    if pad_atoms is None:
        pad_atoms = round_up(max(max(len(e) for e, _ in systems), 1), pad_multiple())
    devices = shard_devices(device)
    bounds = [max_dim_bound(e, c) for e, c in systems]
    if reference_max_diameter is None:
        reference_max_diameter = _largest_exact_maxd(systems, devices[0])
    sizes = batch_sizes(reference_max_diameter, max(bounds), cfg)
    padded = list(systems) + [systems[0]] * (pad_batch_to_devices(b, len(devices)) - b)
    parts = shard_bounds(len(padded), len(devices))

    def run(i: int, dev: torch.device):
        lo, hi = parts[i]
        with profiling.device_stage(span, dev, book=False) as shard:
            mols = encode_batch(padded[lo:hi], pad_to=pad_atoms, device=dev)
            flat = _analysis.run_pipeline(mols, sizes, cfg)
        return flat, (dev, shard)

    shards = _on_shards(devices, run)
    return ([f for f, _ in shards], b, cfg, reference_max_diameter, span, [s for _, s in shards])


def _to_dicts(flat: np.ndarray, cfg: AnalysisConfig) -> list[dict]:
    """A fetched block's properties dicts, with the escalation markers
    still in, and the counters they feed."""
    with stage("sweep_to_dicts"):
        results = to_properties_dicts_bulk(flat, cfg.max_windows)
    if profiling.enabled():
        METRICS.count("molecules_analysed", len(results))
        METRICS.count(
            "windows_found",
            sum(
                0 if r["windows"]["diameters"] is None else len(r["windows"]["diameters"])
                for r in results
            ),
        )
    return results


def collect_batch(handle) -> list[dict]:
    """Fetch a dispatched batch (one device-to-host transfer a shard),
    in frame order without the padding, and convert it to properties
    dicts (with the escalation markers still in)."""
    flats, b, cfg, _, span, shards = handle
    with stage("sweep_fetch"):
        parts = [f.cpu().numpy() for f in flats]
        flat = (parts[0] if len(parts) == 1 else np.concatenate(parts))[:b]
    if span:
        profiling.settle_shards(span, shards)
    return _to_dicts(flat, cfg)


def analyze_batch(
    systems: list[tuple[np.ndarray, np.ndarray]],
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    reference_max_diameter: float | None = None,
    pad_atoms: int | None = None,
    device: DeviceSpec | None = None,
) -> list[dict]:
    """Analyse many (elements, coordinates) systems as device batches on
    ``device`` (every local card unless the caller asks for others or
    the CPU); one reference-schema properties dict per system.

    The sampling-point count is one static for the batch, from
    ``reference_max_diameter`` (default: the largest member's maximum
    diameter), so trajectory frames of one system match the reference's
    per-frame count except at log-scale boundaries; pass a value to pin
    it.  A batch larger than :func:`max_safe_batch` splits into chunks
    that share the pin.
    """
    if not systems:
        return []
    n_max = max(len(e) for e, _ in systems)
    maxd = max(max_dim_bound(e, c) for e, c in systems)
    safe = max_safe_batch(n_max, maxd, cfg, device)
    if len(systems) > safe:
        if reference_max_diameter is None:
            reference_max_diameter = _largest_exact_maxd(systems, device)
        logger.info(
            "splitting batch of %d into memory-safe chunks of %d",
            len(systems), safe,
        )
        out: list[dict] = []
        for lo in range(0, len(systems), safe):
            out.extend(
                analyze_batch(
                    systems[lo : lo + safe], cfg,
                    reference_max_diameter=reference_max_diameter,
                    pad_atoms=pad_atoms, device=device,
                )
            )
        return out

    with stage("batch_analysis"):
        handle = dispatch_batch(
            systems, cfg, reference_max_diameter=reference_max_diameter,
            pad_atoms=pad_atoms, device=device,
        )
        results = collect_batch(handle)
    # the retry keeps the pin the dispatch resolved, so the escalated
    # subset keeps the batch's sampling-point count
    with stage("sweep_retry"):
        return retry_saturated_windows(
            systems, results, cfg, reference_max_diameter=handle[3],
            pad_atoms=pad_atoms, device=device,
        )


def sweep_uniform(
    elements: np.ndarray,
    coords: np.ndarray,
    maxd_per_frame: np.ndarray,
    on_batch,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    batch_size: int | None = None,
    reference_max_diameter: float | None = None,
    device: DeviceSpec | None = None,
    bound_max_diameter: float | None = None,
    learn_caps: bool = True,
    on_rows=None,
) -> None:
    """Full-analysis sweep over frames (F, N, 3) that share one element
    list and are decoded already, in chunks of ``batch_size`` frames
    (default: the largest memory-safe batch), through the loop of
    :func:`sweep_stream` with the sizes known up front (no escalation).

    The per-atom fields move to each device once; only each chunk's
    coordinates move per chunk.  ``maxd_per_frame`` (F,) are the frames'
    exact maximum diameters: their maximum pins the sampling sizes
    unless ``reference_max_diameter`` is given, and sizes the ray paths
    unless ``bound_max_diameter`` is given (the largest maximum diameter
    of a sweep these frames are one part of).  ``learn_caps=False``
    opens every chunk at ``cfg`` and escalates frame by frame, reading
    and writing no :data:`LEARNED_CAPS`.  ``on_batch(positions,
    results)`` receives each chunk's frame positions and final dicts, in
    chunk order, except the frames whose fast run stopped on an
    optimiser budget: those are held back, re-run together at the full
    budgets after the last chunk (or once a chunk's worth is held), and
    delivered in one more call.  No frame is delivered twice.
    ``on_rows(positions, rows, redone)``, when given, first receives
    each such call's packed rows as fetched (markers in; a chunk's
    rows include its held-back frames) and ``{index in the call: dict}``
    of the frames whose dicts came from a re-run.
    """
    if coords.shape[0] == 0:
        return
    maxd = np.asarray(maxd_per_frame, dtype=np.float64)

    def decode_slab(lo, hi, out64=None, out32=None):
        for out in (out64, out32):
            if out is not None:
                out[...] = coords[lo:hi]
        return maxd[lo:hi]

    _sweep_frames(
        elements, len(coords), decode_slab, on_batch, cfg, batch_size,
        ref=None if reference_max_diameter is None else float(reference_max_diameter),
        bound_maxd=float(np.max(maxd) if bound_max_diameter is None else bound_max_diameter),
        device=device, preloaded=coords if coords.dtype == np.float64 else None,
        learn_caps=learn_caps, on_rows=on_rows,
    )


def sweep_stream(
    elements: np.ndarray,
    n_frames: int,
    decode_slab,
    on_batch,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    batch_size: int | None = None,
    reference_max_diameter: float | None = None,
    size_gate: dict | None = None,
    device: DeviceSpec | None = None,
) -> None:
    """Overlapped decode and device sweep over ``n_frames`` frames that
    share one element list (counterpart of
    ``pywindow_tpu.parallel.batch.sweep_stream``).

    ``decode_slab(lo, hi, out64=None, out32=None) -> maxd (hi - lo,)``
    decodes frame positions [lo, hi) into the given (hi - lo, N, 3)
    float64 or float32 slab (the sweep's own store in its pipeline
    dtype) and returns their exact maximum diameters; it may release the
    GIL, since slab k+1 decodes on a thread while the device runs chunk
    k.  The sampling pin is the largest maximum diameter decoded so far
    (or ``reference_max_diameter``); when a later slab makes the discrete
    sampling sizes grow, the sweep restarts over the decoded frames at
    the new sizes and ``on_batch`` receives their results again,
    overwriting.  The results, and their delivery (each chunk's final
    dicts, the frames held back for the full-budget re-run in one more
    call), are those of :func:`sweep_uniform` on the same frames, which
    runs the same loop with the sizes known up front.

    ``size_gate``: a dict whose ``"final"`` key the sweep keeps true
    exactly while no escalation can come any more (every frame decoded,
    the pass at the final sizes), so a caller can hold back checkpoints
    until then.
    """
    _sweep_frames(
        elements, n_frames, decode_slab, on_batch, cfg, batch_size,
        ref=None if reference_max_diameter is None else float(reference_max_diameter),
        bound_maxd=None, device=device, size_gate=size_gate,
    )


#: chunks dispatched ahead of the one being collected (the JAX package's
#: depth, pywindow_tpu/parallel/batch.py:165)
_PIPELINE_DEPTH = 3
#: frames decoded before the first dispatch when no batch size is given
_FIRST_SLAB = 4320


def _fetch(flat_dev: torch.Tensor, done, stream) -> np.ndarray:
    """A chunk's packed results on the host: on the card one copy on
    ``stream`` once the chunk's ``done`` event has fired (a later chunk's
    work does not hold it up), into host memory that nothing reuses."""
    if stream is None:
        return flat_dev.numpy()
    with torch.cuda.stream(stream):
        stream.wait_event(done)
        return flat_dev.to("cpu").numpy()


class _Lane:
    """One shard position of a sweep's chunks: the per-atom fields on its
    device and, on the card, its copy and fetch streams."""

    def __init__(self, device: torch.device, host_rows: tuple) -> None:
        cuda = device.type == "cuda"
        self.rows = [torch.as_tensor(a, device=device) for a in host_rows]
        self.fields: dict[int, tuple] = {}
        self.copy = torch.cuda.Stream(device) if cuda else None
        self.fetch = torch.cuda.Stream(device) if cuda else None

    def fields_for(self, m: int) -> tuple:
        if m not in self.fields:
            self.fields[m] = tuple(r.expand(m, -1).contiguous() for r in self.rows)
        return self.fields[m]


def _sweep_frames(
    elements: np.ndarray,
    n_frames: int,
    decode_slab,
    on_batch,
    cfg: AnalysisConfig,
    batch_size: int | None,
    ref: float | None,
    bound_maxd: float | None,
    device: DeviceSpec,
    size_gate: dict | None = None,
    preloaded: np.ndarray | None = None,
    learn_caps: bool = True,
    on_rows=None,
) -> None:
    """The chunk loop of :func:`sweep_uniform` and :func:`sweep_stream`
    (counterpart of ``pywindow_tpu.parallel.batch._sweep_frames``).

    ``ref``: the sampling pin, or None for the largest maximum diameter
    decoded so far.  ``bound_maxd``: the frames' largest maximum
    diameter when it is known (sizes final, no escalation checks), or
    None to follow the decoded maximum and restart when the sizes grow.
    ``preloaded``: the decoded (n_frames, N, 3) float64 frames, the
    retries' source (and the store itself on a float64 pipeline).
    ``learn_caps``, ``on_rows``: see :func:`sweep_uniform`.

    One thread decodes slab k+1 (``decode_slab``) while the devices run
    chunk k; up to :data:`_PIPELINE_DEPTH` chunks are dispatched ahead of
    the one being collected; one collector thread fetches each chunk's
    packed results, converts them, re-runs the saturated frames and
    calls ``on_batch``, in chunk order.  Frames that stopped on a fast
    optimiser budget are not re-run there: the pass holds them back,
    with the config their chunk ran at, and once every chunk is
    collected (or a chunk's worth is held, after collecting every chunk
    in flight) re-runs them at the full budgets in one
    :func:`analyze_batch` per config, from the main thread with nothing
    else queued on the devices, and delivers them in one more
    ``on_batch`` call; a restart drops them with the pass.  On the card
    the store of decoded frames is pinned host memory that the decoder
    fills in one native pass and nothing rewrites, so a shard's
    coordinates go from it to its device on a side stream whose event
    the compute stream waits on, and the retries read the same store;
    the chunk loop never synchronises a device.  On the CPU (which the
    caller asks for) the store is a plain host array.  A short last
    chunk runs at its own size.  Over several devices each chunk is
    sharded as in :func:`dispatch_batch`, its padding rows copies of its
    first frame; ``sweep_step`` books one span a chunk
    (:func:`~pywindow_torch.profiling.settle_shards`).
    """
    if n_frames == 0:
        return
    devices = shard_devices(device)
    cuda = devices[0].type == "cuda"
    n = len(elements)
    dtype = default_dtype(devices[0])
    np_dtype = numpy_dtype(dtype)
    n_pad = round_up(max(n, 1), pad_multiple())

    with stage("sweep_open"):
        # constant per-atom fields: one host encode, one transfer a device
        _, mass, vdw, cov, mask = encode_host(elements, np.zeros((n, 3)), n_pad, np_dtype)
        lanes = [_Lane(dev, (mass, vdw, cov, mask)) for dev in devices]

        # decoded frames accumulate in the pipeline dtype (a restart never
        # decodes again), pinned on the card; the retries read the float64
        # frames where the caller has them, else this store (a float32 frame
        # is what the pipeline would see of its float64 source anyway)
        fill_store = cuda or preloaded is None or preloaded.dtype != np_dtype
        if fill_store:
            store_t = torch.empty((n_frames, n, 3), dtype=dtype, pin_memory=cuda)
            store = store_t.numpy()
        else:
            store = preloaded
            store_t = torch.as_tensor(store)
    retry_src = store if preloaded is None else preloaded
    slab_key = "out64" if np_dtype == np.float64 else "out32"
    maxd_pf = np.empty(n_frames, dtype=np.float64)
    state = {"decoded": 0}
    # the caller's unit (a sweep's id): each chunk's spans add its
    # number, which a restart's chunks continue
    ids = profiling.current()
    first = 0

    def decode_into(hi: int, chunk: int) -> None:
        with stage("sweep_decode", chunk=chunk):
            lo = state["decoded"]
            outs = {slab_key: store[lo:hi]} if fill_store else {}
            maxd_pf[lo:hi] = decode_slab(lo, hi, **outs)
            state["decoded"] = hi

    streaming = bound_maxd is None
    # sticky cap escalation (see finish): learned per system and base
    # config for the life of the process, kept across restarts
    esc_key = (hash(np.asarray(elements).tobytes()), n_pad, cfg)
    cfg_live = {"cfg": LEARNED_CAPS.get(esc_key, cfg) if learn_caps else cfg}

    def current_sizes() -> tuple:
        run_max = bound_maxd if not streaming else float(np.max(maxd_pf[: state["decoded"]]))
        pin = ref if ref is not None else run_max
        return pin, batch_sizes(pin, run_max, cfg)

    while True:  # a streamed sweep restarts when the sizes escalate
        if state["decoded"] == 0:
            with stage("sweep_decode_wait", chunk=0):  # the first slab: nothing to overlap
                decode_into(min(n_frames, batch_size or _FIRST_SLAB), 0)
        pin, sizes = current_sizes()
        if size_gate is not None:
            size_gate["final"] = not streaming or state["decoded"] == n_frames
        c = max_safe_batch(n_pad, pin, cfg, device) if batch_size is None else int(batch_size)
        c = max(1, min(c, n_frames))
        plan = chunk_plan(n_frames, c)
        # the pass's frames whose fast run stopped on an optimiser budget,
        # held back from their chunks' deliveries: (chunk config,
        # positions, packed rows for on_rows); a restart drops them
        held: list = []
        state["held"] = 0

        def dispatch(lo: int, hi: int):
            m = hi - lo
            chunk_cfg = cfg_live["cfg"]
            if chunk_cfg is not cfg:
                METRICS.count("frames_at_learned_caps", m)
            shards = shard_bounds(pad_batch_to_devices(m, len(lanes)), len(lanes))

            def enqueue(i: int, dev: torch.device):
                lane, (a, b) = lanes[i], shards[i]
                # rows [a, b) of the chunk: stored frames, then copies of
                # the chunk's first frame past its end
                rows = slice(lo + min(a, m), lo + min(b, m))
                reps = max(0, b - max(a, m))
                with stage("sweep_h2d"):
                    if cuda:
                        compute = torch.cuda.current_stream(dev)
                        with torch.cuda.stream(lane.copy):
                            tight = store_t[rows].to(dev, non_blocking=True)
                            first = store_t[lo : lo + 1].to(dev, non_blocking=True) if reps else None
                            copied = torch.cuda.Event()
                            copied.record(lane.copy)
                        compute.wait_event(copied)
                        for t in (tight, first):
                            if t is not None:
                                t.record_stream(compute)
                    else:
                        tight = store_t[rows]
                        first = store_t[lo : lo + 1]
                with stage("sweep_dispatch"), profiling.device_stage("sweep_step", dev, book=False) as span:
                    if reps:
                        tight = torch.cat([tight, first.expand(reps, -1, -1)])
                    coords = torch.cat([tight, tight.new_full((b - a, n_pad - n, 3), FAR_AWAY)], 1)
                    flat = _analysis.run_pipeline(
                        MolArrays(coords, *lane.fields_for(b - a)), sizes, chunk_cfg
                    )
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(compute)
                return flat, done, (dev, span)

            return _on_shards(devices, enqueue), chunk_cfg

        def finish(lo: int, hi: int, handle) -> None:
            parts, chunk_cfg = handle
            with stage("sweep_fetch"):
                got = [_fetch(f, done, lane.fetch) for lane, (f, done, _) in zip(lanes, parts)]
                flat = got[0] if len(got) == 1 else np.concatenate(got)[: hi - lo]
            profiling.settle_shards("sweep_step", [span for _, _, span in parts])
            del parts, handle
            results = _to_dicts(flat, chunk_cfg)
            esc: dict = {}
            deferred: list = []
            with stage("sweep_retry"):
                results = retry_saturated_windows(
                    [(elements, retry_src[i]) for i in range(lo, hi)],
                    results, chunk_cfg, escalation_sink=esc, defer_budget=deferred,
                    reference_max_diameter=pin, device=device,
                )
            positions = np.arange(lo, hi, dtype=np.int64)
            if on_rows is not None:
                on_rows(positions, flat, {i: results[i] for i in esc["redone"]})
            if deferred:
                # held back for the pass's gathered full-budget re-run
                held.append((chunk_cfg, positions[deferred], flat[deferred] if on_rows else None))
                state["held"] += len(deferred)
                skip = set(deferred)
                positions = np.delete(positions, deferred)
                results = [r for i, r in enumerate(results) if i not in skip]
            # sticky escalation for later chunks, only when the marker is
            # endemic (a majority of the chunk): a stray frame is cheaper
            # through the per-chunk retry it just took.  A chunk already
            # dispatched runs at the old caps and retries its frames:
            # their results are the same either way.
            endemic = (hi - lo) // 2
            live = cfg_live["cfg"]
            nxt = live
            if esc.get("open_overflow", 0) > endemic:
                frac = 2.0 * chunk_cfg.open_cap_frac
                if frac > nxt.open_cap_frac:
                    nxt = dataclasses.replace(nxt, open_cap_frac=frac)
            if esc.get("window_sat", 0) > endemic:
                w = min(2 * chunk_cfg.max_windows, MAX_WINDOWS_CEILING)
                if w > nxt.max_windows:
                    nxt = dataclasses.replace(nxt, max_windows=w)
            # memory guard: keep the per-chunk retry when the escalated
            # config no longer fits a chunk
            if learn_caps and nxt is not live and max_safe_batch(n_pad, pin, nxt, device) >= c:
                cfg_live["cfg"] = nxt
                LEARNED_CAPS.put(esc_key, nxt)
                for field in ("open_cap_frac", "max_windows"):
                    if getattr(nxt, field) != getattr(live, field):
                        METRICS.count(f"caps_learned.{field}")
            with stage("sweep_on_batch"):
                on_batch(positions, results)

        def rerun_held() -> None:
            """The held-back frames re-run at the full budgets, one
            ``analyze_batch`` per config they ran at, and delivered in
            one call; run with no chunk in flight, so that the batch
            waits for no other work on the device."""
            runs = collections.defaultdict(list)
            for chunk_cfg, pos, rows in held:
                runs[chunk_cfg].append((pos, rows))
            METRICS.count("frames_budget_gathered", state["held"])
            held.clear()
            state["held"] = 0
            positions, rows, results = [], [], []
            with stage("sweep_retry"):
                for chunk_cfg, parts in runs.items():
                    pos = np.concatenate([p for p, _ in parts])
                    results += _rerun(
                        [(elements, retry_src[i]) for i in pos],
                        dataclasses.replace(chunk_cfg, fast_budgets=False), "budget",
                        reference_max_diameter=pin, device=device,
                    )
                    positions.append(pos)
                    rows += [r for _, r in parts]
            positions = np.concatenate(positions)
            if on_rows is not None:
                on_rows(positions, np.concatenate(rows), dict(enumerate(results)))
            with stage("sweep_on_batch"):
                on_batch(positions, results)

        escalated = False
        with (
            ThreadPoolExecutor(max_workers=1) as collector,
            ThreadPoolExecutor(max_workers=1) as decoder,
        ):
            inflight: collections.deque = collections.deque()  # dispatched
            collects: collections.deque = collections.deque()  # queued collects
            pending = None  # the decode in flight

            def queue_collect() -> None:
                k0, lo0, hi0, h0 = inflight.popleft()
                job = collector.submit(profiling.call, {**ids, "chunk": k0}, finish, lo0, hi0, h0)
                collects.append((k0, job))

            def collect_all() -> None:
                while inflight:
                    queue_collect()
                while collects:
                    collects.popleft()[1].result()

            for k, (lo, hi) in enumerate(plan, first):
                # this chunk's frames must be decoded
                while state["decoded"] < hi and not escalated:
                    with stage("sweep_decode_wait", chunk=k):
                        if pending is not None:
                            pending.result()
                            pending = None
                        else:
                            decode_into(min(state["decoded"] + c, n_frames), k)
                    escalated = streaming and current_sizes()[1] != sizes
                # a prefetch that has finished may escalate too
                if pending is not None and pending.done():
                    pending.result()
                    pending = None
                    escalated = streaming and current_sizes()[1] != sizes
                if escalated:
                    break
                if size_gate is not None and pending is None and state["decoded"] == n_frames:
                    size_gate["final"] = True  # every slab decoded, no escalation
                if pending is None and state["decoded"] < n_frames:
                    hi_next = min(state["decoded"] + c, n_frames)
                    pending = decoder.submit(profiling.call, ids, decode_into, hi_next, k + 1)
                inflight.append((k, lo, hi, profiling.call({"chunk": k}, dispatch, lo, hi)))
                if len(inflight) > _PIPELINE_DEPTH:
                    queue_collect()
                # retire finished collects (raises their errors, bounds
                # the queue)
                while len(collects) > 1:
                    k0, job = collects.popleft()
                    with stage("sweep_collect_wait", chunk=k0):
                        job.result()
                # a chunk's worth of held-back frames re-runs at once,
                # which bounds what a long sweep holds back
                if state["held"] >= c:
                    with stage("sweep_drain"):
                        collect_all()
                    rerun_held()
            # drain (also on the escalated break: the prefetch writes
            # the store the restart reads)
            with stage("sweep_drain"):
                if pending is not None:
                    pending.result()
                collect_all()
        if not escalated:
            if held:
                rerun_held()
            return
        METRICS.count("sweep_restarts")
        first += len(plan)
        logger.info(
            "sweep sampling sizes escalated mid-stream (%s -> %s); "
            "restarting over the %d decoded frames",
            sizes, current_sizes()[1], state["decoded"],
        )


def _rerun(systems, cfg: AnalysisConfig, reason: str, **analyze_kwargs) -> list[dict]:
    """``analyze_batch`` of escalated molecules at ``cfg``: a
    ``sweep_rerun`` span whose id ``reason`` is the marker, its
    molecules counted as ``frames_retried.<reason>``."""
    METRICS.count(f"frames_retried.{reason}", len(systems))
    with stage("sweep_rerun", reason=reason):
        return analyze_batch(systems, cfg, **analyze_kwargs)


def retry_saturated_windows(
    systems,
    results: list[dict],
    cfg: AnalysisConfig,
    escalation_sink: dict | None = None,
    defer_budget: list | None = None,
    **analyze_kwargs,
) -> list[dict]:
    """Re-run the molecules whose device run outgrew a static cap
    (counterpart of ``pywindow_tpu.parallel.batch.retry_saturated_windows``).

    - ``_open_cap_overflow``: the open rays overflowed the compaction
      cap: re-run with a doubled ``open_cap_frac``;
    - ``_opt_budget_exceeded``: an optimiser stopped on its fast budget:
      re-run at the full budgets;
    - ``_window_cap_saturated``: as many clusters as window slots:
      re-run with a doubled ``max_windows`` (up to
      :data:`~pywindow_torch.config.MAX_WINDOWS_CEILING`).

    A molecule re-run at the full budgets is not re-run for its windows
    as well: that re-run's own retry handles them.  ``defer_budget``: a
    list that receives the indices of the fast-budget molecules instead
    of re-running them (their results stay the fast run's, for the
    caller to replace by one full-budget re-run of its own).

    Pops the markers from every result; ``escalation_sink`` receives the
    counts per marker (``open_overflow``, ``budget``, ``window_sat``) and
    the sorted indices whose results a re-run replaced (``redone``).  The
    molecules re-run count as ``frames_retried.<marker>``; each re-run
    is a ``sweep_rerun`` span whose id ``reason`` is its marker.
    """
    redone: set = set()

    def rerun(idxs: list[int], cfg2: AnalysisConfig, reason: str) -> None:
        redo = _rerun([systems[i] for i in idxs], cfg2, reason, **analyze_kwargs)
        for i, r in zip(idxs, redo):
            results[i] = r
        redone.update(idxs)

    over = [i for i, r in enumerate(results) if r.pop("_open_cap_overflow", False)]
    if over:
        rerun(over, dataclasses.replace(cfg, open_cap_frac=2.0 * cfg.open_cap_frac), "open_overflow")

    budget = [i for i, r in enumerate(results) if r.pop("_opt_budget_exceeded", False)]
    deferred: set = set()
    if budget and cfg.fast_budgets:
        if defer_budget is None:
            rerun(budget, dataclasses.replace(cfg, fast_budgets=False), "budget")
        else:
            defer_budget.extend(budget)
            deferred.update(budget)

    idxs = [
        i for i, r in enumerate(results)
        if r.pop("_window_cap_saturated", False) and i not in deferred
    ]
    if idxs and cfg.max_windows >= MAX_WINDOWS_CEILING:
        logger.warning(
            "%d molecule(s) still saturate max_windows=%d at the escalation "
            "ceiling; raise AnalysisConfig.max_windows",
            len(idxs), cfg.max_windows,
        )
    elif idxs:
        rerun(idxs, dataclasses.replace(cfg, max_windows=2 * cfg.max_windows), "window_sat")
    if escalation_sink is not None:
        escalation_sink.update(
            open_overflow=len(over), budget=len(budget), window_sat=len(idxs),
            redone=sorted(redone),
        )
    return results
