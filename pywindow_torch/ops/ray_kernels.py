"""The ray kernels: ``ray_exit``, ``path_sweep`` and ``fine_path``
(counterpart of ``pywindow_tpu.ops.pallas_kernels``).

Each kernel has three functions here:

- ``<name>_plain``: the plain PyTorch version, used for tensors on the
  CPU and as the reference the CUDA kernel is held against;
- ``<name>_cuda``: the wrapper of the hand-written CUDA kernel
  (``csrc/<name>.cu``); it validates its inputs, launches on the current
  stream (the binding checks the launch) and counts the launch in
  :data:`~pywindow_torch.ops._cuda.LAUNCHES`;
- ``<name>``: the entry point, which takes the plain version for CPU
  tensors and the kernel for CUDA tensors.  It never moves work between
  devices and never falls back: a CUDA tensor that the kernel refuses
  raises.

Every function takes a leading frame axis B: rays (B, P, 3) over
molecules (B, N, 3), one launch for all frames.

The three kernels skip, by exact bounds, the atoms that cannot change
their outputs (``csrc/ray_exit.cu`` and ``csrc/ray_cull.cuh``, whose walk
``path_sweep`` and ``fine_path`` share, derive them).
:func:`ray_exit_keep` and :func:`path_sweep_keep` mirror the two rules
with the kernels' operations; the tests and ``chip_smoke.py`` use them,
the pipeline does not (the plain versions evaluate every atom).
"""

from __future__ import annotations

import torch

from pywindow_torch.ops import _cuda
from pywindow_torch.ops.geometry import BIG, pairwise_distances, sq_norm3

#: the grid's frame axis (CUDA's y dimension) of ray_exit and path_sweep
MAX_FRAMES = 65535

#: rays per ray_exit tile: one warp
RAY_TILE = 32
#: ray_exit's cone cull: the cone is widened by CONE_ULPS unit roundoffs
#: (plus the rays' norm error) and the margin is CULL_ULPS of them
EXIT_CONE_ULPS = 8.0
EXIT_CULL_ULPS = 64.0
#: path_sweep's cull margin in unit roundoffs, and the |v|^2 at or below
#: which a ray is treated as the origin (2^-100)
SWEEP_CULL_ULPS = 64.0
SWEEP_TINY_VV = 2.0**-100


def _unit_roundoff(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).eps / 2.0


# ---------------------------------------------------------------------------
# ray_exit: replaces pallas_kernels.py::ray_exit_pallas (+ _wide)
# ---------------------------------------------------------------------------


def ray_exit_plain(
    unit: torch.Tensor,
    rel: torch.Tensor,
    vdw: torch.Tensor,
    origin: torch.Tensor,
    want_exit: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per ray (any_front, max_exit): the JAX package's off-TPU path,
    ``ray_sphere_intersections`` reduced over atoms (rays.py:121-155,
    :370-375).

    unit (B, P, 3) unit directions; rel (B, N, 3) atoms relative to
    ``origin`` (padded atoms at 0 with vdW 0, which never hit); vdw
    (B, N); origin (B, 3).  ``max_exit`` is -1e30 for rays with no front
    hit, and everywhere when ``want_exit`` is False.
    """
    # t_ca per coordinate, in the kernel's order: a matmul would round
    # differently, and on a grazing ray a last-bit change of the hit
    # test below changes which atom gives the farthest exit
    u, x = unit[..., :, None, :], rel[..., None, :, :]
    t_ca = u[..., 0] * x[..., 0] + u[..., 1] * x[..., 1] + u[..., 2] * x[..., 2]
    # stable perpendicular form: |rel|^2 - t_ca^2 cancels near tangency
    perp = x - t_ca[..., None] * u
    under = (vdw * vdw)[..., None, :] - sq_norm3(perp)
    hits = under > 0.0
    t_hc = torch.sqrt(torch.where(hits, under, 0.0))
    o = origin[..., None, None, :]
    p0 = o + (t_ca - t_hc)[..., None] * u
    p1 = o + (t_ca + t_hc)[..., None] * u
    p1_norm2 = sq_norm3(p1)
    front = hits & (sq_norm3(p0) < p1_norm2)
    any_front = front.any(-1)
    if not want_exit:
        return any_front, torch.full_like(unit[..., 0], -BIG)
    exit_norm = torch.sqrt(p1_norm2)
    return any_front, torch.where(front, exit_norm, -BIG).amax(-1)


def ray_exit_cuda(
    unit: torch.Tensor,
    rel: torch.Tensor,
    vdw: torch.Tensor,
    origin: torch.Tensor,
    want_exit: bool,
    order: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ray_exit_plain` through the CUDA kernel (``csrc/ray_exit.cu``).

    ``order`` (P,) int32, a permutation of the rays
    (:func:`~pywindow_torch.ops.rays.spiral_tile_order` for the golden
    spiral; ``torch.arange(P)`` is index order, whose tiles cull little),
    groups them into the kernel's 32-ray tiles, each culling the
    atoms that cannot cross any of its rays (:func:`ray_exit_keep`);
    every output still goes to its ray's own index.  The kernel's front
    test is the algebraic form ``t_hc > 0 and t_ca + o.u > 0`` of the
    plain version's ``|p0|^2 < |p1|^2``, and its exit is ``sqrt`` of the
    expanded ``|p1|^2`` after the max; in float32 the two may disagree on
    rays within rounding of tangency.
    """
    dtype = unit.dtype
    device = _cuda.check_inputs(
        "ray_exit", dtype, unit=unit, rel=rel, vdw=vdw, origin=origin
    )
    if unit.ndim != 3 or rel.ndim != 3:
        msg = f"ray_exit: unit and rel must be (B, P, 3), (B, N, 3), got {unit.shape}, {rel.shape}"
        raise ValueError(msg)
    b, p, n = unit.shape[0], unit.shape[1], rel.shape[1]
    _cuda.check_shape("ray_exit", unit, (b, p, 3), "unit")
    _cuda.check_shape("ray_exit", rel, (b, n, 3), "rel")
    _cuda.check_shape("ray_exit", vdw, (b, n), "vdw")
    _cuda.check_shape("ray_exit", origin, (b, 3), "origin")
    _cuda.check_inputs("ray_exit", dtype, unit=unit, order=order)
    _cuda.check_shape("ray_exit", order, (p,), "order")
    if order.dtype != torch.int32:
        msg = f"ray_exit: order must be int32, got {order.dtype}"
        raise TypeError(msg)
    if b > MAX_FRAMES:
        msg = f"ray_exit: {b} frames in one launch (at most {MAX_FRAMES})"
        raise ValueError(msg)
    any_front = torch.empty((b, p), dtype=torch.bool, device=device)
    max_exit = torch.empty((b, p), dtype=dtype, device=device)
    _cuda.load_extension().ray_exit(
        unit, rel, vdw, origin, any_front, max_exit, bool(want_exit), order
    )
    _cuda.count_launch("ray_exit")
    return any_front, max_exit


def ray_exit(unit, rel, vdw, origin, want_exit: bool, order: torch.Tensor):
    """Per ray (any_front, max_exit); see :func:`ray_exit_plain`
    (``order`` groups the kernel's rays, see :func:`ray_exit_cuda`; the
    plain version has no use for it)."""
    if _cuda.device_type("ray_exit", unit) == "cuda":
        return ray_exit_cuda(unit, rel, vdw, origin, want_exit, order)
    return ray_exit_plain(unit, rel, vdw, origin, want_exit)


def _butterfly_lane0(t: torch.Tensor) -> torch.Tensor:
    """Lane 0's sum of a warp's xor-butterfly (offsets 16 .. 1, its own
    value first) over the axis -2 of size 32: the kernel's order."""
    for half in (16, 8, 4, 2, 1):
        t = t[..., :half, :] + t[..., half : 2 * half, :]
    return t[..., 0, :]


def ray_exit_keep(
    unit: torch.Tensor, rel: torch.Tensor, vdw: torch.Tensor, order: torch.Tensor
) -> torch.Tensor:
    """(B, T, N) bool: the atoms each 32-ray tile of ``ray_exit``'s kernel
    keeps, by its cone rule with its operations (``csrc/ray_exit.cu`` has
    the derivation); tile k holds the rays ``order[32k : 32k + 32]``."""
    b, p, _ = unit.shape
    dtype, device = unit.dtype, unit.device
    tiles = -(-p // RAY_TILE)
    idx = torch.full((tiles * RAY_TILE,), -1, dtype=torch.int64, device=device)
    idx[:p] = order.to(torch.int64)
    live = (idx >= 0).reshape(tiles, RAY_TILE)
    u = unit[:, idx.clamp_min(0)].reshape(b, tiles, RAY_TILE, 3)
    u = torch.where(live[None, :, :, None], u, 0.0)
    s = _butterfly_lane0(u)  # (B, T, 3)
    norm = torch.sqrt(sq_norm3(s))
    a0, a1, a2 = (s[..., k] / norm for k in range(3))
    u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
    a0l, a1l, a2l = a0[..., None], a1[..., None], a2[..., None]
    c = (a0l * u0 + a1l * u1 + a2l * u2).abs()
    x0 = a1l * u2 - a2l * u1
    x1 = a2l * u0 - a0l * u2
    x2 = a0l * u1 - a1l * u0
    sn = torch.sqrt(x0 * x0 + x1 * x1 + x2 * x2)
    e = ((u0 * u0 + u1 * u1 + u2 * u2) - 1.0).abs()
    c = torch.where(live, c, torch.inf).amin(-1)
    sn = torch.where(live, sn, 0.0).amax(-1)
    uroff = _unit_roundoff(dtype)
    e = torch.where(live, e, 0.0).amax(-1) + 4.0 * uroff
    widen = EXIT_CONE_ULPS * uroff + e
    cos_lo, sin_hi = (c - widen)[..., None], (sn + widen)[..., None]
    coef = (EXIT_CULL_ULPS * (uroff + e))[..., None]
    r0, r1, r2 = (rel[:, None, :, k] for k in range(3))  # (B, 1, N)
    h = (a0l * r0 + a1l * r1 + a2l * r2).abs()
    c0 = a1l * r2 - a2l * r1
    c1 = a2l * r0 - a0l * r2
    c2 = a0l * r1 - a1l * r0
    lhs = torch.sqrt(c0 * c0 + c1 * c1 + c2 * c2) * cos_lo - h * sin_hi
    r = vdw[:, None, :].abs()
    xl1 = (r0.abs() + r1.abs()) + r2.abs()
    drop = (vdw[:, None, :] == 0.0) | (lhs >= r + coef * (xl1 + r))
    return ~drop


# ---------------------------------------------------------------------------
# path_sweep: replaces pallas_kernels.py::path_sweep_pallas (+ _wide)
# ---------------------------------------------------------------------------


def path_sweep_plain(
    vectors: torch.Tensor,
    chunks: torch.Tensor,
    coords: torch.Tensor,
    vdw: torch.Tensor,
    max_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per ray (ok, pos, cmin) of the clearance at ``l * v / chunks``,
    l < min(chunks + 1, max_steps): the dense path of the JAX package
    (rays.py:336-351).

    vectors (B, P, 3); chunks (B, P) int32 >= 1; coords (B, N, 3) and
    vdw (B, N) with padded atoms at ~1e6 and vdW 0.  Returns ok (B, P)
    bool, pos (B, P) int32 (first minimum), cmin (B, P).
    """
    dtype = vectors.dtype
    steps = torch.arange(max_steps, dtype=dtype, device=vectors.device)
    frac = steps / chunks[..., None].to(dtype)  # (B, P, L)
    pathway = vectors[..., None, :] * frac[..., None]  # (B, P, L, 3)
    dist = pairwise_distances(pathway, coords[..., None, :, :])
    c = (dist - vdw[..., None, None, :]).amin(-1)  # (B, P, L)
    valid = steps.to(torch.int32) <= chunks[..., None]
    ok = ((c > 0.0) | ~valid).all(-1)
    c_masked = torch.where(valid, c, BIG)
    pos = c_masked.argmin(-1)
    cmin = c_masked.gather(-1, pos[..., None])[..., 0]
    return ok, pos.to(torch.int32), cmin


def _segment(vectors: torch.Tensor):
    """Per ray (v0, v1, v2, 1/|v|^2 or 0, slack) as ``csrc/path_sweep.cu``'s
    ``Segment`` computes them, each (B, P, 1)."""
    v0, v1, v2 = (vectors[..., k, None] for k in range(3))
    vv = v0 * v0 + v1 * v1 + v2 * v2
    vl1 = (v0.abs() + v1.abs()) + v2.abs()
    proj = vv > SWEEP_TINY_VV
    inv_vv = torch.where(proj, 1.0 / torch.where(proj, vv, 1.0), 0.0)
    margin = SWEEP_CULL_ULPS * _unit_roundoff(vectors.dtype)
    slack = margin * vl1 + torch.where(proj, 0.0, vl1)
    return v0, v1, v2, inv_vv, slack


def path_sweep_bounds(
    vectors: torch.Tensor, coords: torch.Tensor, vdw: torch.Tensor
) -> torch.Tensor:
    """(B, P, N): each atom's lower bound on its computed clearance at
    every probe of the ray's segment [0, v], with the operations of
    ``csrc/path_sweep.cu`` (whose header derives the margin)."""
    v0, v1, v2, inv_vv, slack = _segment(vectors)
    margin = SWEEP_CULL_ULPS * _unit_roundoff(vectors.dtype)
    x0, x1, x2 = (coords[..., None, :, k] for k in range(3))  # (B, 1, N)
    r = vdw[..., None, :]
    t = torch.clamp((x0 * v0 + x1 * v1 + x2 * v2) * inv_vv, 0.0, 1.0)
    p0 = x0 - t * v0
    p1 = x1 - t * v1
    p2 = x2 - t * v2
    dist = torch.sqrt(p0 * p0 + p1 * p1 + p2 * p2)
    scale = ((x0.abs() + x1.abs()) + x2.abs()) + r
    return (dist - r) - (margin * scale + slack)


def path_sweep_keep(
    vectors: torch.Tensor,
    chunks: torch.Tensor,
    coords: torch.Tensor,
    vdw: torch.Tensor,
    max_steps: int,
) -> torch.Tensor:
    """(B, P, N) bool: the atoms ``path_sweep``'s kernel keeps for each
    ray: LB_i <= max(U, 0), with U the clearance of the atom of least
    bound (first on ties) at the valid step nearest its projection on
    the ray, computed with the plain version's arithmetic."""
    dtype = vectors.dtype
    lb = path_sweep_bounds(vectors, coords, vdw)
    lbm = torch.where(torch.isnan(lb), torch.inf, lb)
    star = lbm.argmin(-1)  # (B, P), first minimum
    atom = coords.gather(1, star[..., None].expand(-1, -1, 3))  # (B, P, 3)
    radius = vdw.gather(1, star)
    v0, v1, v2, inv_vv, _ = _segment(vectors)
    a0, a1, a2 = (atom[..., k, None] for k in range(3))
    t = torch.clamp((a0 * v0 + a1 * v1 + a2 * v2) * inv_vv, 0.0, 1.0)[..., 0]
    chunksf = chunks.to(dtype)
    n_steps = torch.clamp_max(chunks + 1, max_steps)
    step = torch.minimum(torch.round(t * chunksf).to(torch.int32).clamp_min(0), n_steps - 1)
    q = vectors * (step.to(dtype) / chunksf)[..., None]
    u = torch.sqrt(sq_norm3(q - atom)) - radius
    has = (lbm.amin(-1) < torch.inf) & (n_steps > 0)
    bound = torch.where(has, torch.clamp_min(u, 0.0), torch.inf)
    return ~(lb > bound[..., None])


def path_sweep_origin_rays(
    vectors: torch.Tensor, chunks: torch.Tensor, max_steps: int
) -> torch.Tensor:
    """(B, P) bool: the rays ``path_sweep``'s kernel answers from its
    block's origin clearance, with no cull and no walk: zero vectors with
    chunks >= 1 and at least one step (every probe is the origin)."""
    steps = torch.clamp_max(chunks + 1, max_steps)
    return (vectors == 0).all(-1) & (chunks >= 1) & (steps >= 1)


#: path_sweep's warps per block (csrc/path_sweep.cu, PATH_SWEEP_THREADS),
#: and the blocks of 256 threads an H100 SM holds at once (2,048 threads)
SWEEP_WARPS = 8
SWEEP_BLOCKS_PER_SM = 8


def sweep_rays_per_warp(frames: int, rays: int, sms: int) -> int:
    """Rays each warp of ``path_sweep`` walks, one after another: the
    fewest of 1, 2 and 4 that fit the launch in one wave of blocks (one
    molecule, a small batch: the launch is latency-bound, and a warp's
    rays run one after another), else 4 (a batch that fills the card many
    times over: a block's staging and origin clearance then serve 32
    rays; one ray a warp read 24% slower on a 1,440-frame chunk, PERF.md).
    Any value gives the same outputs."""
    wave = SWEEP_BLOCKS_PER_SM * sms
    for rays_per_warp in (1, 2):
        if frames * -(-rays // (SWEEP_WARPS * rays_per_warp)) <= wave:
            return rays_per_warp
    return 4


def path_sweep_smem_bytes(n: int, element_size: int) -> int:
    """Shared memory of a ``path_sweep`` or ``fine_path`` block (both are
    8 walking warps, ``pw::walk_smem_bytes`` in ``csrc/ray_cull.cuh``):
    the frame's atoms as (x, y, z, r) records, and for each warp a
    kept-atom bit mask and the atoms' bounds."""
    return 4 * n * element_size + 8 * 4 * (-(-n // 32)) + 8 * n * element_size


def _sweep_checks(name, vectors, chunks, coords, vdw, smem_bytes):
    dtype = vectors.dtype
    device = _cuda.check_inputs(
        name, dtype, vectors=vectors, chunks=chunks, coords=coords, vdw=vdw
    )
    if vectors.ndim != 3 or coords.ndim != 3:
        msg = f"{name}: vectors and coords must be (B, R, 3), (B, N, 3), got {vectors.shape}, {coords.shape}"
        raise ValueError(msg)
    b, r, n = vectors.shape[0], vectors.shape[1], coords.shape[1]
    _cuda.check_shape(name, vectors, (b, r, 3), "vectors")
    _cuda.check_shape(name, coords, (b, n, 3), "coords")
    _cuda.check_shape(name, vdw, (b, n), "vdw")
    _cuda.check_shape(name, chunks, (b, r), "chunks")
    if chunks.dtype != torch.int32:
        msg = f"{name}: chunks must be int32, got {chunks.dtype}"
        raise TypeError(msg)
    _cuda.check_smem(name, smem_bytes(n, vectors.element_size()))
    ok = torch.empty((b, r), dtype=torch.bool, device=device)
    pos = torch.empty((b, r), dtype=torch.int32, device=device)
    cmin = torch.empty((b, r), dtype=dtype, device=device)
    return ok, pos, cmin


def path_sweep_cuda(
    vectors: torch.Tensor,
    chunks: torch.Tensor,
    coords: torch.Tensor,
    vdw: torch.Tensor,
    max_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`path_sweep_plain` through the CUDA kernel
    (``csrc/path_sweep.cu``): the same outputs bit for bit, from only the
    atoms :func:`path_sweep_keep` keeps, with the same arithmetic and
    tie rule; :func:`sweep_rays_per_warp` sets the launch."""
    ok, pos, cmin = _sweep_checks(
        "path_sweep", vectors, chunks, coords, vdw, path_sweep_smem_bytes
    )
    if vectors.shape[0] > MAX_FRAMES:
        msg = f"path_sweep: {vectors.shape[0]} frames in one launch (at most {MAX_FRAMES})"
        raise ValueError(msg)
    b, p = vectors.shape[:2]
    _cuda.load_extension().path_sweep(
        vectors, chunks, coords, vdw, ok, pos, cmin, int(max_steps),
        sweep_rays_per_warp(b, p, _cuda.sm_count(vectors.device)),
    )
    _cuda.count_launch("path_sweep")
    return ok, pos, cmin


def path_sweep(vectors, chunks, coords, vdw, max_steps: int):
    """Per ray (ok, pos, cmin); see :func:`path_sweep_plain`."""
    if _cuda.device_type("path_sweep", vectors) == "cuda":
        return path_sweep_cuda(vectors, chunks, coords, vdw, max_steps)
    return path_sweep_plain(vectors, chunks, coords, vdw, max_steps)


# ---------------------------------------------------------------------------
# fine_path: replaces pallas_kernels.py::_fine_path_flat
# ---------------------------------------------------------------------------


def _fine_scan(vectors, chunks, coords, vdw, max_steps, chunk_len):
    """The JAX package's step-chunked scan (``_fine_scan_flat``) over
    every slot: vectors (B, W, 3) over coords (B, N, 3)."""
    dtype, device = vectors.dtype, vectors.device
    chunksf = chunks.to(dtype)
    n_blocks = (max_steps + chunk_len - 1) // chunk_len
    all_steps = torch.arange(
        n_blocks * chunk_len, dtype=dtype, device=device
    ).reshape(n_blocks, chunk_len)
    shape = vectors.shape[:-1]
    ok = torch.ones(shape, dtype=torch.bool, device=device)
    pos = torch.zeros(shape, dtype=dtype, device=device)
    cmin = torch.full(shape, BIG, dtype=dtype, device=device)
    atoms = coords[..., None, :, :]
    radii = vdw[..., None, None, :]
    for steps in all_steps:
        frac = steps / chunksf[..., None]  # (B, W, chunk)
        pathway = vectors[..., None, :] * frac[..., None]
        c = (pairwise_distances(pathway, atoms) - radii).amin(-1)
        valid = (steps.to(torch.int32) <= chunks[..., None]) & (
            steps < max_steps
        )
        ok = ok & ((c > 0.0) | ~valid).all(-1)
        c_masked = torch.where(valid, c, BIG)
        blk_min = c_masked.amin(-1)
        blk_pos = steps[c_masked.argmin(-1)]
        better = blk_min < cmin  # strict: earlier blocks keep ties
        cmin = torch.where(better, blk_min, cmin)
        pos = torch.where(better, blk_pos, pos)
    return ok, pos.to(torch.int32), cmin


def fine_path_plain(
    vectors: torch.Tensor,
    chunks: torch.Tensor,
    coords: torch.Tensor,
    vdw: torch.Tensor,
    max_steps: int,
    active: torch.Tensor | None = None,
    chunk_len: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`path_sweep_plain` for the W window-slot rays of each frame
    at the fine increment, as the JAX package scans it
    (``_fine_scan_flat``, pallas_kernels.py:714-757): the path in
    ``chunk_len``-step blocks reduced into running (ok, first-argmin
    step, min clearance) carries, strict < across blocks, which gives
    :func:`path_sweep_plain`'s outputs bit for bit.

    vectors (B, W, 3), chunks (B, W) int32, coords (B, N, 3), vdw (B, N),
    ``active`` (B, W) bool or None (every slot) -> ok (B, W) bool, pos
    (B, W) int32, cmin (B, W).  Only active slots are computed; the others
    hold the kernel's placeholders: ok False, pos 0, cmin 1e30.
    """
    if active is None:
        return _fine_scan(vectors, chunks, coords, vdw, max_steps, chunk_len)
    b, w = vectors.shape[:2]
    frame = torch.arange(b, device=vectors.device).repeat_interleave(w)

    def lanes(vec, ch, fr):  # (L, 3), (L,), (L,) -> (L,) outputs
        out = _fine_scan(vec[:, None], ch[:, None], coords[fr], vdw[fr], max_steps, chunk_len)
        return tuple(o[:, 0] for o in out)

    placeholders = (
        torch.zeros(b * w, dtype=torch.bool, device=vectors.device),
        torch.zeros(b * w, dtype=torch.int32, device=vectors.device),
        torch.full((b * w,), BIG, dtype=vectors.dtype, device=vectors.device),
    )
    out = _cuda.on_active_lanes(
        active.reshape(b * w), lanes,
        (vectors.reshape(b * w, 3), chunks.reshape(b * w), frame), placeholders,
    )
    return tuple(o.reshape(b, w) for o in out)


def fine_path_cuda(
    vectors: torch.Tensor,
    chunks: torch.Tensor,
    coords: torch.Tensor,
    vdw: torch.Tensor,
    max_steps: int,
    active: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`fine_path_plain` through the CUDA kernel
    (``csrc/fine_path.cu``): the same outputs bit for bit, from only the
    atoms :func:`path_sweep_keep` keeps (the rule of ``path_sweep``), and
    the same placeholders on inactive slots."""
    ok, pos, cmin = _sweep_checks(
        "fine_path", vectors, chunks, coords, vdw, path_sweep_smem_bytes
    )
    b, w = vectors.shape[:2]
    if b > MAX_FRAMES:
        msg = f"fine_path: {b} frames in one launch (at most {MAX_FRAMES})"
        raise ValueError(msg)
    if active is not None:
        _cuda.check_inputs("fine_path", vectors.dtype, vectors=vectors, active=active)
        _cuda.check_active("fine_path", active.reshape(-1), b * w)
        _cuda.check_shape("fine_path", active, (b, w), "active")
    _cuda.load_extension().fine_path(
        vectors, chunks, coords, vdw, active, ok, pos, cmin, int(max_steps)
    )
    _cuda.count_launch("fine_path")
    return ok, pos, cmin


def fine_path(vectors, chunks, coords, vdw, max_steps: int, active=None):
    """Per window-slot ray (ok, pos, cmin); see :func:`fine_path_plain`."""
    if _cuda.device_type("fine_path", vectors) == "cuda":
        return fine_path_cuda(vectors, chunks, coords, vdw, max_steps, active)
    return fine_path_plain(vectors, chunks, coords, vdw, max_steps, active)
