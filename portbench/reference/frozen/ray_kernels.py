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

from portbench.reference.frozen import _cuda
from portbench.reference.frozen.geometry import BIG, pairwise_distances, sq_norm3


#: rays per ray_exit tile: one warp
RAY_TILE = 32
#: path_sweep's cull margin in unit roundoffs, and the |v|^2 at or below
#: which a ray is treated as the origin (2^-100)
SWEEP_CULL_ULPS = 64.0
SWEEP_TINY_VV = 2.0**-100


def _unit_roundoff(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).eps / 2.0


# ---------------------------------------------------------------------------
# ray_exit: replaces pallas_kernels.py::ray_exit_pallas (+ _wide)
# ---------------------------------------------------------------------------


def sphere_crossings(
    unit: torch.Tensor, rel: torch.Tensor, vdw: torch.Tensor, origin: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per (ray, atom), each (B, P, N): whether the ray's line crosses
    the atom's vdW sphere, whether the crossing's entry point is nearer
    the ray origin than its exit ('front'), and the exit point's squared
    norm (``rays.py:121-155`` of the JAX package); the inputs are
    :func:`ray_exit_plain`'s."""
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
    return hits, hits & (sq_norm3(p0) < p1_norm2), p1_norm2


def ray_exit_plain(
    unit: torch.Tensor,
    rel: torch.Tensor,
    vdw: torch.Tensor,
    origin: torch.Tensor,
    want_exit: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per ray (any_front, max_exit): the JAX package's off-TPU path,
    :func:`sphere_crossings` reduced over atoms (rays.py:121-155,
    :370-375).

    unit (B, P, 3) unit directions; rel (B, N, 3) atoms relative to
    ``origin`` (padded atoms at 0 with vdW 0, which never hit); vdw
    (B, N); origin (B, 3).  ``max_exit`` is -1e30 for rays with no front
    hit, and everywhere when ``want_exit`` is False.
    """
    _, front, p1_norm2 = sphere_crossings(unit, rel, vdw, origin)
    any_front = front.any(-1)
    if not want_exit:
        return any_front, torch.full_like(unit[..., 0], -BIG)
    exit_norm = torch.sqrt(p1_norm2)
    return any_front, torch.where(front, exit_norm, -BIG).amax(-1)


def ray_exit(unit, rel, vdw, origin, want_exit: bool, order: torch.Tensor):
    """Per ray (any_front, max_exit); see :func:`ray_exit_plain`
    (``order`` groups the kernel's rays, see :func:`ray_exit_cuda`; the
    plain version has no use for it)."""
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


def path_sweep(vectors, chunks, coords, vdw, max_steps: int):
    """Per ray (ok, pos, cmin); see :func:`path_sweep_plain`."""
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


def fine_path(vectors, chunks, coords, vdw, max_steps: int, active=None):
    """Per window-slot ray (ok, pos, cmin); see :func:`fine_path_plain`."""
    return fine_path_plain(vectors, chunks, coords, vdw, max_steps, active)
