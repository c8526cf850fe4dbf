"""Golden-spiral sampling and the ray analyses (counterpart of
``pywindow_tpu.ops.rays``).

Rays start at the coordinate mean of the (already centred) molecule and
run along unit vectors towards points of a sampling sphere centred at
the origin (reference: utilities.py:1100-1161, :1556-1583).  The two
per-ray reductions go through :mod:`pywindow_torch.ops.ray_kernels`:
``ray_exit`` for the pre-analysis and the average diameter,
``path_sweep`` for the coarse path sweep and ``fine_path`` for the
W-slot fine re-sampling.  Every function takes molecules with a leading
frame axis (B, N) and rays (B, P, 3); the plain versions also take one
unbatched molecule.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from pywindow_torch.ops import ray_kernels
from pywindow_torch.ops.encoding import MolArrays
from pywindow_torch.ops.geometry import center_of_coor, pairwise_distances, sq_norm3


def number_of_points(sphere_radius: float, adjust: float = 1.0) -> int:
    """Sampling-point count ``int(log10(4 pi r^2) * 250 * adjust)``
    (reference: utilities.py:1398-1409)."""
    area = 4.0 * np.pi * float(sphere_radius) ** 2
    return int(np.log10(area) * 250.0 * adjust)


def linspace(start, stop, num: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace`` (endpoint included) with JAX's own arithmetic:
    ``start * (1 - i/div) + stop * (i/div)``, then ``stop`` exactly.
    ``start``/``stop`` may be tensors with batch dims (-> (..., num))."""
    start = torch.as_tensor(start, dtype=dtype, device=device)
    stop = torch.as_tensor(stop, dtype=dtype, device=device)
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None]], dim=-1)


def golden_spiral(n_points: int, radius: torch.Tensor) -> torch.Tensor:
    """``n_points`` golden-angle spiral points on a sphere of ``radius``
    (a 0-d tensor, or (B,) for one sphere per frame -> (B, P, 3)), the
    reference's layout (utilities.py:1410-1423)."""
    dtype, device = radius.dtype, radius.device
    golden_angle = math.pi * (
        3.0 - torch.sqrt(torch.tensor(5.0, dtype=dtype, device=device))
    )
    theta = golden_angle * torch.arange(n_points, dtype=dtype, device=device)
    z = linspace(
        1.0 - 1.0 / n_points, 1.0 / n_points - 1.0, n_points, dtype, device
    )
    rho = torch.sqrt(1.0 - z * z)
    return radius[..., None, None] * torch.stack(
        [rho * torch.cos(theta), rho * torch.sin(theta), z], dim=-1
    )


def mean_knn_eps(points: torch.Tensor, k: int = 10) -> torch.Tensor:
    """DBSCAN eps of a point set (..., P, 3): the mean of each point's
    ``k`` smallest distances, itself included, plus the mean's square
    root (reference: utilities.py:1424-1434, whose KDTree query counts
    the point itself); :func:`mean_knn_eps_scaled` is its form for a
    spiral of known radius."""
    nearest = torch.topk(pairwise_distances(points, points), k, dim=-1, largest=False).values
    m = nearest.mean((-2, -1))
    return m + torch.sqrt(m)


@functools.lru_cache(maxsize=32)
def _unit_mean_knn(n_points: int, k: int, dtype_name: str) -> float:
    """Mean k-NN distance (self included) of the unit-radius spiral: a
    host constant per point count (the k-NN mean scales with radius)."""
    dtype = np.dtype(dtype_name)
    golden_angle = np.pi * (3.0 - np.sqrt(dtype.type(5.0)))
    kk = np.arange(n_points, dtype=dtype)
    theta = golden_angle * kk
    z = np.linspace(
        1.0 - 1.0 / n_points, 1.0 / n_points - 1.0, n_points, dtype=dtype
    )
    rho = np.sqrt(1.0 - z * z)
    pts = np.stack(
        [rho * np.cos(theta), rho * np.sin(theta), z], axis=-1
    )
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    nearest = np.sort(d, axis=1)[:, :k]
    return float(nearest.mean())


def mean_knn_eps_scaled(
    n_points: int, radius: torch.Tensor, k: int = 10
) -> torch.Tensor:
    """DBSCAN eps for a spiral of ``radius``: ``m*r + sqrt(m*r)`` with
    ``m`` the unit-sphere mean k-NN distance, :func:`mean_knn_eps` of
    the spiral without its P x P distances (reference:
    utilities.py:1424-1434)."""
    name = str(radius.dtype).removeprefix("torch.")
    m = radius * _unit_mean_knn(n_points, k, name)
    return m + torch.sqrt(m)


def _spiral_tile_order_np(n_points: int) -> np.ndarray:
    """The golden spiral's points cut into compact 32-ray patches: bands
    of z (the spiral's index order) about one patch's side high, each a
    whole number of patches except the last, sorted by longitude within
    the band.  Spiral point k has z = 1 - (2k + 1)/n and longitude
    k times the golden angle."""
    tile = ray_kernels.RAY_TILE
    k = np.arange(n_points)
    z = 1.0 - (2.0 * k + 1.0) / n_points
    phi = np.mod(np.pi * (3.0 - np.sqrt(5.0)) * k, 2.0 * np.pi)
    side = np.sqrt(4.0 * np.pi * tile / n_points)  # a square patch's side
    order, start = [], 0
    while start < n_points:
        # a band's height in z is its arc height times rho at its middle
        rho_top = np.sqrt(max(1.0 - z[start] ** 2, 0.0))
        z_mid = z[start] - 0.5 * side * rho_top
        rho = np.sqrt(max(1.0 - z_mid**2, 0.0))
        count = tile * max(1, round(n_points * side * rho / 2.0 / tile))
        band = k[start : start + count]
        order.append(band[np.argsort(phi[band], kind="stable")])
        start += count
    return np.concatenate(order).astype(np.int32)


@functools.lru_cache(maxsize=32)
def spiral_tile_order(n_points: int, device: torch.device) -> torch.Tensor:
    """(P,) int32 on ``device``: the order in which ``ray_exit``'s kernel
    takes the spiral's rays, 32 to a tile (a permutation of range(P); it
    groups the rays and changes no result)."""
    return torch.as_tensor(_spiral_tile_order_np(n_points), device=device)


def _ray_frame(
    points: torch.Tensor, mol: MolArrays
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(unit directions, atoms relative to the ray origin, origin)."""
    unit = points / torch.sqrt(sq_norm3(points))[..., None]
    origin = center_of_coor(mol)
    rel = torch.where(mol.mask[..., None], mol.coords - origin[..., None, :], 0.0)
    return unit, rel, origin


class RayIntersections(NamedTuple):
    """Per (ray, atom) sphere-crossing quantities, each (..., P, N)."""

    hits: torch.Tensor  # bool: the ray's line crosses the vdW sphere
    front: torch.Tensor  # bool: its entry point is nearer the origin
    exit_norm: torch.Tensor  # |p1|, the distance of the far crossing


def ray_sphere_intersections(points: torch.Tensor, mol: MolArrays) -> RayIntersections:
    """Each sampling ray (..., P, 3) against every vdW sphere of ``mol``:
    the pairs that ``ray_exit`` and its plain version reduce over (the
    same arithmetic, :func:`~pywindow_torch.ops.ray_kernels.sphere_crossings`),
    padded atoms masked out."""
    unit, rel, origin = _ray_frame(points, mol)
    hits, front, p1_norm2 = ray_kernels.sphere_crossings(unit, rel, mol.vdw, origin)
    valid = mol.mask[..., None, :]
    return RayIntersections(hits & valid, front & valid, torch.sqrt(p1_norm2))


def preanalysis_open(points: torch.Tensor, mol: MolArrays) -> torch.Tensor:
    """True for rays with no blocking ('front') sphere intersection
    (reference ``vector_preanalysis``, utilities.py:1132-1161)."""
    unit, rel, origin = _ray_frame(points, mol)
    order = spiral_tile_order(points.shape[-2], points.device)
    any_front, _ = ray_kernels.ray_exit(
        unit, rel, mol.vdw, origin, want_exit=False, order=order
    )
    return ~any_front


def reversed_exit_distance(
    points: torch.Tensor, mol: MolArrays
) -> tuple[torch.Tensor, torch.Tensor]:
    """(has_front, farthest front exit distance) per ray, for the
    average diameter (reference: utilities.py:1556-1583)."""
    unit, rel, origin = _ray_frame(points, mol)
    order = spiral_tile_order(points.shape[-2], points.device)
    return ray_kernels.ray_exit(
        unit, rel, mol.vdw, origin, want_exit=True, order=order
    )


def average_diameter(
    mol: MolArrays, n_points: int, sphere_radius: torch.Tensor
) -> torch.Tensor:
    """``2 * mean(max exit distance)`` over rays that hit anything; the
    sampling radius is the full maximum diameter (reference:
    utilities.py:1586-1650)."""
    has, dist = reversed_exit_distance(
        golden_spiral(n_points, sphere_radius), mol
    )
    total = torch.where(has, dist, 0.0).sum(-1)
    return 2.0 * total / has.sum(-1).to(dist.dtype)


class PathAnalysis(NamedTuple):
    """Result of sampling clearance along each ray path."""

    ok: torch.Tensor  # (..., P) all path clearances positive
    dist: torch.Tensor  # (..., P) distance from origin to narrowest point
    width: torch.Tensor  # (..., P) 2 * clearance at the narrowest point
    narrow: torch.Tensor  # (..., P, 3) coordinates of the narrowest point


def _chunks(vectors: torch.Tensor, increment: float):
    norm = torch.sqrt(sq_norm3(vectors))
    chunks = torch.clamp_min(torch.floor(norm / increment).to(torch.int32), 1)
    return norm, chunks


def _path_result(vectors, norm, chunks, ok, pos, cmin) -> PathAnalysis:
    dtype = vectors.dtype
    posf = pos.to(dtype)
    chunksf = chunks.to(dtype)
    return PathAnalysis(
        ok=ok,
        dist=norm * posf / chunksf,
        width=2.0 * cmin,
        narrow=vectors * (posf / chunksf)[..., None],
    )


def path_analysis(
    vectors: torch.Tensor, mol: MolArrays, increment: float, max_steps: int
) -> PathAnalysis:
    """Walk each vector (P, 3) from the origin in ``increment`` steps:
    clearance at the ``chunks + 1`` points ``i * v / chunks``, the ray
    open iff every clearance is positive (reference:
    utilities.py:1100-1129).  ``max_steps`` bounds the walk statically.
    Runs on ``ray_kernels.path_sweep``."""
    norm, chunks = _chunks(vectors, increment)
    ok, pos, cmin = ray_kernels.path_sweep(
        vectors, chunks, mol.coords, mol.vdw, max_steps
    )
    return _path_result(vectors, norm, chunks, ok, pos, cmin)


def fine_path_analysis(
    vectors: torch.Tensor,
    mol: MolArrays,
    increment: float,
    max_steps: int,
    active: torch.Tensor | None = None,
) -> PathAnalysis:
    """:func:`path_analysis` for the few W-slot rays (B, W, 3) of the
    window refinement, at the fine increment; runs on
    ``ray_kernels.fine_path``, whose plain version is the JAX package's
    step-chunked scan (rays.py:219-271).  Only the ``active`` (B, W)
    slots are walked (None: every slot); the others hold
    ``fine_path``'s placeholders (not ok, distance 0, width 2e30)."""
    norm, chunks = _chunks(vectors, increment)
    ok, pos, cmin = ray_kernels.fine_path(
        vectors, chunks, mol.coords, mol.vdw, max_steps, active
    )
    return _path_result(vectors, norm, chunks, ok, pos, cmin)
