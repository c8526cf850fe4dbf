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
"""

from __future__ import annotations

import torch

from pywindow_torch.ops import _cuda
from pywindow_torch.ops.geometry import BIG, pairwise_distances, sq_norm3

#: the grid's frame axis (CUDA's y dimension) of ray_exit and path_sweep
MAX_FRAMES = 65535


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
    want_exit: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ray_exit_plain` through the CUDA kernel (``csrc/ray_exit.cu``).

    The kernel's front test is the algebraic form ``t_hc > 0 and
    t_ca + o.u > 0`` of the plain version's ``|p0|^2 < |p1|^2``, and its
    exit is ``sqrt`` of the expanded ``|p1|^2`` after the max; in float32
    the two may disagree on rays within rounding of tangency.
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
    if b > MAX_FRAMES:
        msg = f"ray_exit: {b} frames in one launch (at most {MAX_FRAMES})"
        raise ValueError(msg)
    any_front = torch.empty((b, p), dtype=torch.bool, device=device)
    max_exit = torch.empty((b, p), dtype=dtype, device=device)
    _cuda.load_extension().ray_exit(
        unit, rel, vdw, origin, any_front, max_exit, bool(want_exit)
    )
    _cuda.LAUNCHES["ray_exit"] += 1
    return any_front, max_exit


def ray_exit(unit, rel, vdw, origin, want_exit: bool = True):
    """Per ray (any_front, max_exit); see :func:`ray_exit_plain`."""
    if _cuda.device_type("ray_exit", unit) == "cuda":
        return ray_exit_cuda(unit, rel, vdw, origin, want_exit)
    return ray_exit_plain(unit, rel, vdw, origin, want_exit)


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


def _sweep_checks(name, vectors, chunks, coords, vdw):
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
    _cuda.check_smem(name, 4 * n * vectors.element_size())
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
    (``csrc/path_sweep.cu``); same arithmetic, same tie rule."""
    ok, pos, cmin = _sweep_checks("path_sweep", vectors, chunks, coords, vdw)
    if vectors.shape[0] > MAX_FRAMES:
        msg = f"path_sweep: {vectors.shape[0]} frames in one launch (at most {MAX_FRAMES})"
        raise ValueError(msg)
    _cuda.load_extension().path_sweep(
        vectors, chunks, coords, vdw, ok, pos, cmin, int(max_steps)
    )
    _cuda.LAUNCHES["path_sweep"] += 1
    return ok, pos, cmin


def path_sweep(vectors, chunks, coords, vdw, max_steps: int):
    """Per ray (ok, pos, cmin); see :func:`path_sweep_plain`."""
    if _cuda.device_type("path_sweep", vectors) == "cuda":
        return path_sweep_cuda(vectors, chunks, coords, vdw, max_steps)
    return path_sweep_plain(vectors, chunks, coords, vdw, max_steps)


# ---------------------------------------------------------------------------
# fine_path: replaces pallas_kernels.py::_fine_path_flat
# ---------------------------------------------------------------------------


def fine_path_plain(
    vectors: torch.Tensor,
    chunks: torch.Tensor,
    coords: torch.Tensor,
    vdw: torch.Tensor,
    max_steps: int,
    chunk_len: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`path_sweep_plain` for the W window-slot rays of each frame
    at the fine increment, as the JAX package scans it
    (``_fine_scan_flat``, pallas_kernels.py:714-757): the path in
    ``chunk_len``-step blocks reduced into running (ok, first-argmin
    step, min clearance) carries, strict < across blocks.

    vectors (B, W, 3), chunks (B, W) int32, coords (B, N, 3), vdw (B, N)
    -> ok (B, W) bool, pos (B, W) int32, cmin (B, W).
    """
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


def fine_path_cuda(
    vectors: torch.Tensor,
    chunks: torch.Tensor,
    coords: torch.Tensor,
    vdw: torch.Tensor,
    max_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`fine_path_plain` through the CUDA kernel
    (``csrc/fine_path.cu``); same arithmetic, same first-minimum rule."""
    ok, pos, cmin = _sweep_checks("fine_path", vectors, chunks, coords, vdw)
    _cuda.load_extension().fine_path(
        vectors, chunks, coords, vdw, ok, pos, cmin, int(max_steps)
    )
    _cuda.LAUNCHES["fine_path"] += 1
    return ok, pos, cmin


def fine_path(vectors, chunks, coords, vdw, max_steps: int):
    """Per window-slot ray (ok, pos, cmin); see :func:`fine_path_plain`."""
    if _cuda.device_type("fine_path", vectors) == "cuda":
        return fine_path_cuda(vectors, chunks, coords, vdw, max_steps)
    return fine_path_plain(vectors, chunks, coords, vdw, max_steps)
