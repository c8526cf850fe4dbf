"""The ray kernels: ``ray_exit`` and ``path_sweep`` (counterpart of
``pywindow_tpu.ops.pallas_kernels``).

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
"""

from __future__ import annotations

import torch

from pywindow_torch.ops import _cuda
from pywindow_torch.ops.geometry import BIG, pairwise_distances, sq_norm3


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

    unit (P, 3) unit directions; rel (N, 3) atoms relative to ``origin``
    (padded atoms at 0 with vdW 0, which never hit); origin (3,).
    ``max_exit`` is -1e30 for rays with no front hit, and everywhere
    when ``want_exit`` is False.
    """
    # t_ca per coordinate, in the kernel's order: a matmul would round
    # differently, and on a grazing ray a last-bit change of the hit
    # test below changes which atom gives the farthest exit
    u, x = unit[:, None, :], rel[None, :, :]
    t_ca = u[..., 0] * x[..., 0] + u[..., 1] * x[..., 1] + u[..., 2] * x[..., 2]
    # stable perpendicular form: |rel|^2 - t_ca^2 cancels near tangency
    perp = x - t_ca[..., None] * u
    under = (vdw * vdw)[None, :] - sq_norm3(perp)
    hits = under > 0.0
    t_hc = torch.sqrt(torch.where(hits, under, 0.0))
    o = origin[None, None, :]
    p0 = o + (t_ca - t_hc)[..., None] * u
    p1 = o + (t_ca + t_hc)[..., None] * u
    p1_norm2 = sq_norm3(p1)
    front = hits & (sq_norm3(p0) < p1_norm2)
    any_front = front.any(-1)
    if not want_exit:
        return any_front, torch.full_like(unit[:, 0], -BIG)
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
    p, n = unit.shape[0], rel.shape[0]
    if unit.shape != (p, 3) or rel.shape != (n, 3) or vdw.shape != (n,):
        msg = f"ray_exit: bad shapes {unit.shape}, {rel.shape}, {vdw.shape}"
        raise ValueError(msg)
    if origin.shape != (3,):
        msg = f"ray_exit: origin must be (3,), got {origin.shape}"
        raise ValueError(msg)
    any_front = torch.empty(p, dtype=torch.bool, device=device)
    max_exit = torch.empty(p, dtype=dtype, device=device)
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

    vectors (P, 3); chunks (P,) int32 >= 1; coords (N, 3) and vdw (N,)
    with padded atoms at ~1e6 and vdW 0.  Returns ok (P,) bool, pos (P,)
    int32 (first minimum), cmin (P,).
    """
    dtype = vectors.dtype
    steps = torch.arange(max_steps, dtype=dtype, device=vectors.device)
    frac = steps / chunks[:, None].to(dtype)  # (P, L)
    pathway = vectors[:, None, :] * frac[..., None]  # (P, L, 3)
    c = (pairwise_distances(pathway, coords) - vdw).amin(-1)  # (P, L)
    valid = steps.to(torch.int32) <= chunks[:, None]
    ok = ((c > 0.0) | ~valid).all(-1)
    c_masked = torch.where(valid, c, BIG)
    pos = c_masked.argmin(-1)
    cmin = c_masked.gather(-1, pos[:, None])[:, 0]
    return ok, pos.to(torch.int32), cmin


def path_sweep_cuda(
    vectors: torch.Tensor,
    chunks: torch.Tensor,
    coords: torch.Tensor,
    vdw: torch.Tensor,
    max_steps: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`path_sweep_plain` through the CUDA kernel
    (``csrc/path_sweep.cu``); same arithmetic, same tie rule."""
    dtype = vectors.dtype
    device = _cuda.check_inputs(
        "path_sweep", dtype,
        vectors=vectors, chunks=chunks, coords=coords, vdw=vdw,
    )
    p, n = vectors.shape[0], coords.shape[0]
    if vectors.shape != (p, 3) or coords.shape != (n, 3) or vdw.shape != (n,):
        msg = (
            f"path_sweep: bad shapes {vectors.shape}, {coords.shape}, "
            f"{vdw.shape}"
        )
        raise ValueError(msg)
    if chunks.shape != (p,) or chunks.dtype != torch.int32:
        msg = f"path_sweep: chunks must be int32 ({p},), got {chunks.dtype} {chunks.shape}"
        raise TypeError(msg)
    ok = torch.empty(p, dtype=torch.bool, device=device)
    pos = torch.empty(p, dtype=torch.int32, device=device)
    cmin = torch.empty(p, dtype=dtype, device=device)
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
