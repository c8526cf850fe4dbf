"""The ``clearance_min`` kernel (counterpart of
``pywindow_tpu.ops.pallas_kernels.clearance_min_pallas``).

:func:`clearance_min` is the vdW clearance field ``min_i(||x_i - p|| -
vdw_i)`` of a set of probe points against one molecule: the plain
version (:func:`clearance_min_plain`, the port's
``geometry.clearance_field`` with every atom valid) for CPU tensors, the
CUDA kernel (``csrc/clearance_min.cu``) for CUDA tensors, with no size
gate and no fallback.  As in the JAX package no pipeline stage calls it:
it is a public function for clearance grids and the like.

The kernel sorts probes and atoms along a Morton curve, cuts the sorted
atoms into 32-atom tiles with boxes, and lets a warp of 32 sorted probes
skip every tile that an exact rule shows cannot lower any lane's
minimum; ``csrc/clearance_min.cu`` derives the rule.
:func:`clearance_keep` mirrors the kernel's orders and rule on the CPU
(the tests hold the minimum over the pairs it keeps equal to the plain
version).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pywindow_torch.ops import _cuda
from pywindow_torch.ops.encoding import unmasked
from pywindow_torch.ops.geometry import clearance_field

#: probes a warp of the sweep, atoms a tile
GROUP = 32
TILE = 32
#: cells an axis of the Morton grid; probe keys [0, CELLS), atom keys
#: [CELLS, 2 CELLS], the last the far key of atoms outside the frame
CELL_BITS = 4
AXIS_CELLS = 1 << CELL_BITS
CELLS = AXIS_CELLS**3
KEYS = 2 * CELLS + 1
#: int32 words of the workspace the kernel's first pass fills: the key
#: counters, two done counters, then the frame (lo, cells per Å) in the
#: probes' dtype at an 8-byte boundary
FRAME_WORD = (KEYS + 3) // 2 * 2
WORK_INTS = FRAME_WORD + 8
#: atoms with a coordinate at or beyond this (Å), or not finite, stay out
#: of the frame (the MolArrays padding parks atoms at 1e6)
FAR = 1.0e5
#: the helper launches of one kernel call, in order, before
#: "clearance_min" (the sweep): the frame, the keys and their scan, the
#: scatter and the tiles
HELPER_KERNELS = ("clearance_frame", "clearance_keys", "clearance_scatter")


def clearance_min_plain(
    probes: torch.Tensor, coords: torch.Tensor, vdw: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: probes (Q, 3), coords (N, 3), vdw (N,) ->
    (Q,).  It holds (Q, N, 3) differences at once."""
    return clearance_field(probes, unmasked(coords, vdw))


class ClearanceWork(NamedTuple):
    """The kernel's workspace (``pw::ClearanceWork``); ``order`` holds,
    after a call, the probe at each sorted position (the first Q entries)
    and then the atom at each sorted position."""

    counts: torch.Tensor
    keys: torch.Tensor
    order: torch.Tensor
    sorted_probes: torch.Tensor
    sorted_atoms: torch.Tensor
    tiles: torch.Tensor


def clearance_workspace(q: int, n: int, dtype: torch.dtype, device: torch.device) -> ClearanceWork:
    return ClearanceWork(
        counts=torch.empty(WORK_INTS, dtype=torch.int32, device=device),
        keys=torch.empty(q + n, dtype=torch.int32, device=device),
        order=torch.empty(q + n, dtype=torch.int32, device=device),
        sorted_probes=torch.empty((q, 3), dtype=dtype, device=device),
        sorted_atoms=torch.empty((n, 4), dtype=dtype, device=device),
        tiles=torch.empty((-(-n // TILE), 8), dtype=dtype, device=device),
    )


def clearance_min_launch(
    probes: torch.Tensor, coords: torch.Tensor, vdw: torch.Tensor
) -> tuple[torch.Tensor, ClearanceWork | None]:
    """The kernel on the card: (out, workspace), the workspace None when
    Q is 0.  Four launches, each counted under its own key in
    ``_cuda.LAUNCHES``."""
    dtype = probes.dtype
    device = _cuda.check_inputs(
        "clearance_min", dtype, probes=probes, coords=coords, vdw=vdw
    )
    q, n = probes.shape[0], coords.shape[0]
    _cuda.check_shape("clearance_min", probes, (q, 3), "probes")
    _cuda.check_shape("clearance_min", coords, (n, 3), "coords")
    _cuda.check_shape("clearance_min", vdw, (n,), "vdw")
    if n == 0:
        msg = "clearance_min: needs at least one atom"
        raise ValueError(msg)
    out = torch.empty(q, dtype=dtype, device=device)
    if q == 0:
        return out, None
    work = clearance_workspace(q, n, dtype, device)
    _cuda.load_extension().clearance_min(probes, coords, vdw, out, *work)
    for key in HELPER_KERNELS:
        _cuda.count_launch(key)
    _cuda.count_launch("clearance_min")
    return out, work


def clearance_min_cuda(
    probes: torch.Tensor, coords: torch.Tensor, vdw: torch.Tensor
) -> torch.Tensor:
    """The kernel on the card: probes (Q, 3), coords (N, 3), vdw (N,), all
    contiguous in the dtype of ``probes`` (float32 or float64) -> (Q,)."""
    return clearance_min_launch(probes, coords, vdw)[0]


def clearance_min(
    probes: torch.Tensor, coords: torch.Tensor, vdw: torch.Tensor
) -> torch.Tensor:
    """``min_i(||x_i - p|| - vdw_i)`` per probe: probes (Q, 3), coords
    (N, 3), vdw (N,) -> (Q,), in the dtype of ``probes``.  Padded atoms
    must be parked far away (~1e6) with vdW 0, so they never win."""
    if _cuda.device_type("clearance_min", probes) == "cuda":
        return clearance_min_cuda(probes, coords, vdw)
    return clearance_min_plain(probes, coords, vdw)


# -- the kernel's orders and rule on the CPU --------------------------------


def _near(coords: torch.Tensor) -> torch.Tensor:
    return (coords.abs() < FAR).all(-1)


def clearance_frame(coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo (3,), scale) of the Morton grid, as the kernel's first two
    passes compute them: the box of the near atoms and 16 cells over its
    longest side (zeros when no atom is near)."""
    near = _near(coords)
    zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
    if not bool(near.any()):
        return torch.zeros(3, dtype=coords.dtype, device=coords.device), zero
    inner = coords[near]
    lo = inner.amin(0)
    ext = (inner.amax(0) - lo).amax()
    scale = torch.where(ext > 0, AXIS_CELLS / torch.where(ext > 0, ext, 1), zero)
    return lo, scale


def _morton(points: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    v = (points - lo) * scale
    v = torch.where(v > 0, v, 0)
    cells = torch.where(v >= AXIS_CELLS - 1, AXIS_CELLS - 1, v).to(torch.int64)
    key = torch.zeros(points.shape[0], dtype=torch.int64, device=points.device)
    for b in range(CELL_BITS):
        for k in range(3):
            key |= ((cells[:, k] >> b) & 1) << (3 * b + k)
    return key


def clearance_keys(
    probes: torch.Tensor, coords: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(probe keys (Q,), atom keys (N,)) of the kernel's sort: Morton
    keys of the frame's 16^3 cells, atoms offset by CELLS and those
    outside the frame at the far key 2 CELLS."""
    lo, scale = clearance_frame(coords)
    atom = CELLS + torch.where(_near(coords), _morton(coords, lo, scale), CELLS)
    return _morton(probes, lo, scale), atom


def clearance_orders(probes: torch.Tensor, coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(probe order (Q,), atom order (N,)): a stable sort by key (the
    kernel's order within a cell may differ; the rule is exact for any)."""
    pk, ak = clearance_keys(probes, coords)
    return torch.sort(pk, stable=True).indices, torch.sort(ak, stable=True).indices


def clearance_tiles(atoms: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(lo (T, 3), largest vdW (T,), hi (T, 3), flag (T,) bool) of the
    32-atom tiles of sorted atoms (N, 4) = (x, y, z, vdW); the flag where
    a coordinate or radius is not finite, box and radius over the finite
    atoms."""
    n = atoms.shape[0]
    tiles = -(-n // TILE)
    pad = torch.full((tiles * TILE - n, 4), torch.nan, dtype=atoms.dtype, device=atoms.device)
    blocks = torch.cat([atoms, pad]).reshape(tiles, TILE, 4)
    live = (torch.arange(tiles * TILE, device=atoms.device) < n).reshape(tiles, TILE)
    finite = torch.isfinite(blocks).all(-1)
    flag = (live & ~finite).any(-1)
    keep = finite[..., None]
    lo = torch.where(keep, blocks, torch.inf).amin(1)
    hi = torch.where(keep, blocks, -torch.inf).amax(1)
    return lo[:, :3], hi[:, 3], hi[:, :3], flag


def box_gap2(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Squared gap from points (..., 3) to boxes (..., 3), as the kernel
    rounds it (a NaN coordinate gives a gap of 0 on its axis)."""
    a = lo - points
    b = points - hi
    g = torch.where(a > b, a, b)
    g = torch.where(g > 0, g, 0)
    return g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]


def skip_threshold(best: torch.Tensor, rmax: torch.Tensor) -> torch.Tensor:
    """The kernel's T: a pair or box whose squared distance is at least T
    cannot lower ``best`` (NaN where no such bound holds)."""
    x = best + rmax
    inf = torch.tensor(torch.inf, dtype=x.dtype, device=x.device)
    sq = torch.nextafter(x, inf) ** 2
    thr = torch.where(sq < inf, torch.nextafter(sq, inf), torch.nan)
    thr = torch.where(x < inf, thr, torch.nan)
    return torch.where(x <= 0, 0, thr)


class ClearanceCull(NamedTuple):
    """What :func:`clearance_keep` returns."""

    #: (G, T) bool: the tiles each group of 32 sorted probes visits
    kept: torch.Tensor
    #: (G, GROUP, T) bool: the tiles each live lane's own test keeps where
    #: its group reaches them (the seed tile, and every tile its own S < T
    #: with its best at that step)
    lane_kept: torch.Tensor
    #: (G, GROUP, T) bool: per live lane, the tile where its minimum was
    #: found and, unless the minimum is NaN, the tiles its test keeps with
    #: that minimum as its best: those an exact cull over these tiles
    #: must look into for that probe, whatever its order (the work the
    #: probe needs)
    needed: torch.Tensor
    #: (Q,) the probe at each sorted position (group g: positions 32g..)
    probe_order: torch.Tensor
    #: (N,) the atom at each sorted position (tile t: positions 32t..)
    atom_order: torch.Tensor
    #: (Q,) per probe, in the caller's order, the minimum over the pairs
    #: of the tiles its group visits
    best: torch.Tensor


def clearance_keep(
    probes: torch.Tensor,
    coords: torch.Tensor,
    vdw: torch.Tensor,
    probe_order: torch.Tensor | None = None,
    atom_order: torch.Tensor | None = None,
) -> ClearanceCull:
    """The kernel's sweep on the CPU (or on any device), for all groups at
    once: the seed tile nearest the group's centre, then the tiles
    outward from it, each kept unless every live lane's squared gap is
    at least its :func:`skip_threshold` (never for a flagged tile, never
    for a lane with a NaN probe).  Orders default to
    :func:`clearance_orders`; the kernel's (``ClearanceWork.order``) may
    be passed instead."""
    q, n = probes.shape[0], coords.shape[0]
    if probe_order is None or atom_order is None:
        po, ao = clearance_orders(probes, coords)
        probe_order = po if probe_order is None else probe_order
        atom_order = ao if atom_order is None else atom_order
    probe_order, atom_order = probe_order.long(), atom_order.long()
    atoms = torch.cat([coords[atom_order], vdw[atom_order, None]], -1)
    lo, rmax, hi, flag = clearance_tiles(atoms)
    nt = lo.shape[0]
    g = -(-q // GROUP)
    # dead lanes of the last group hold its first probe
    slot = torch.arange(g * GROUP, device=probes.device)
    lane_live = (slot < q).reshape(g, GROUP)
    slot = torch.where(slot < q, slot, slot // GROUP * GROUP)
    p = probes[probe_order][slot].reshape(g, GROUP, 3)
    probe_nan = torch.isnan(p).any(-1)
    nan = torch.isnan(p)
    low = torch.where(nan, torch.inf, p).amin(1)
    high = torch.where(nan, -torch.inf, p).amax(1)
    all_nan = nan.all(1)
    centre = torch.where(all_nan, torch.nan, (low + high) * 0.5)
    seed_gap = box_gap2(centre[:, None, :], lo[None], hi[None])
    seed = torch.where(seed_gap < torch.inf, seed_gap, torch.inf).argmin(-1)

    pad = torch.zeros((nt * TILE - n, 4), dtype=atoms.dtype, device=atoms.device)
    tiled = torch.cat([atoms, pad]).reshape(nt, TILE, 4)
    live = (torch.arange(nt * TILE, device=atoms.device) < n).reshape(nt, TILE)
    rows = torch.arange(g, device=probes.device)

    def tile_min(groups: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        a = tiled[t]  # (groups, TILE, 4)
        d = p[groups][:, :, None, :] - a[:, None, :, :3]
        s = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        c = torch.sqrt(s) - a[:, None, :, 3]
        return torch.where(live[t][:, None, :], c, torch.inf).amin(-1)

    kept = torch.zeros((g, nt), dtype=torch.bool, device=probes.device)
    kept[rows, seed] = True
    lane_kept = torch.zeros((g, GROUP, nt), dtype=torch.bool, device=probes.device)
    lane_kept[rows, :, seed] = lane_live
    best = tile_min(rows, seed)
    found = seed[:, None].expand(g, GROUP).clone()  # the tile of each best
    for k in range(1, nt):
        for t in (seed + k, seed - k):
            valid = (t >= 0) & (t < nt)
            if not bool(valid.any()):
                continue
            tc = t.clamp(0, nt - 1)
            thr = torch.where(flag[tc, None], torch.nan, skip_threshold(best, rmax[tc, None]))
            skip = ~probe_nan & (box_gap2(p, lo[tc, None], hi[tc, None]) >= thr)
            visit = rows[valid & ~skip.all(1)]
            lane_kept[visit, :, tc[visit]] = ~skip[visit] & lane_live[visit]
            if visit.numel():
                kept[visit, tc[visit]] = True
                old, new = best[visit], tile_min(visit, tc[visit])
                lower = (new < old) | (torch.isnan(new) & ~torch.isnan(old))
                found[visit] = torch.where(lower, tc[visit, None], found[visit])
                best[visit] = torch.minimum(old, new)
    needed = torch.zeros_like(lane_kept)
    needed.scatter_(2, found[..., None], lane_live[..., None])
    for t in range(nt):
        thr = torch.where(flag[t], torch.nan, skip_threshold(best, rmax[t]))
        needed[:, :, t] |= lane_live & ~torch.isnan(best) & ~(box_gap2(p, lo[t], hi[t]) >= thr)
    flat = best.reshape(-1)[:q]
    out = torch.empty_like(flat)
    out[probe_order] = flat
    return ClearanceCull(kept, lane_kept, needed, probe_order, atom_order, out)
