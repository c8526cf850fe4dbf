"""The window-finding pipeline (counterpart of ``pywindow_tpu.ops.windows``).

Reproduces ``find_windows`` (reference: utilities.py:1364-1553) and the
per-cluster refinement ``window_analysis`` (reference:
utilities.py:1191-1361):

1. shift the molecule so the (optionally optimised) pore centre sits at
   the origin,
2. golden-spiral rays over a sphere of radius max_dim/2; the analytic
   pre-analysis culls blocked rays; the open ones, compacted in order,
   are path-sampled at 1 Å steps and kept if the whole path is clear,
3. DBSCAN over the surviving rays' sphere points,
4. per cluster: the widest ray is re-sampled at 0.1 Å, the molecule is
   rotated so that ray becomes +Z and translated so the ray's narrowest
   point is the origin, then the window centre is refined: bounded 1-D
   L-BFGS-B in z, 20x20 brute grid + Nelder–Mead polish in xy,
5. window diameter = clearance diameter at the refined centre, rotated
   back into the input frame.

Everything runs on a batch of B frames with no loop over frames: the W
window slots of every frame are refined together as B * W optimiser
lanes.  The z and xy stages are the plain versions of the
``lbfgsb_stable`` and ``nm_xy`` kernels (the card's stable optimisers),
in every dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference.frozen import config
from portbench.reference.frozen.config import (
    AnalysisConfig,
    effective_budgets,
)
from portbench.reference.frozen import rays
from portbench.reference.frozen.cluster import dbscan
from portbench.reference.frozen.encoding import MolArrays
from portbench.reference.frozen.geometry import (
    BIG,
    center_of_mass,
    clearance_field,
    max_dim_value,
    pore_diameter,
)
from portbench.reference.frozen.lbfgsb_kernels import EMB_Z, lbfgsb_stable_flat
from portbench.reference.frozen.nm_kernels import nm_xy_flat


class WindowsResult(NamedTuple):
    """Padded window sets of a batch of molecules (unpacked on the host:
    one molecule, without the batch axis)."""

    diameters: torch.Tensor  # (B, W)
    centers: torch.Tensor  # (B, W, 3) in the input coordinate frame
    valid: torch.Tensor  # (B, W) bool
    any_open: torch.Tensor  # (B,) bool; False == the reference's None return
    n_clusters: torch.Tensor  # (B,) int32 (before refinement failures)
    refine_failed: torch.Tensor  # (B, W) bool, for warning parity
    open_overflow: torch.Tensor  # bool: open rays exceeded the compaction
    #                             cap (the host re-runs with a doubled
    #                             cfg.open_cap_frac)
    opt_capped: torch.Tensor  # bool: a real window slot (or, once
    #                          full_analysis_device adds it, the pore
    #                          centre) stopped on its fast budget (the
    #                          host re-runs with cfg.fast_budgets=False)


def open_cap(n_points: int, frac: float) -> int | None:
    """Compacted open-ray slot count, or ``None`` when compaction is off
    (a cap that would not shrink the sweep disables it)."""
    if frac >= 1.0:
        return None
    k = ((int(math.ceil(n_points * frac)) + 127) // 128) * 128
    return k if k < n_points else None


def _octant_angles(vector: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotation angles taking ``vector`` (..., 3) to +Z, with the
    reference's per-octant sign table (utilities.py:1235-1258)."""
    vx, vy, vz = vector[..., 0], vector[..., 1], vector[..., 2]
    two_pi = 2.0 * math.pi
    # angle_between uses |dot|, so both raw angles are in [0, pi/2]
    # (reference: utilities.py:1088-1097)
    a1r = torch.arccos(torch.clamp(vx.abs() / torch.sqrt(vx * vx + vy * vy), 0.0, 1.0))
    vnorm = torch.sqrt(vx * vx + vy * vy + vz * vz)
    a2r = torch.arccos(torch.clamp(vz.abs() / vnorm, 0.0, 1.0))
    xp, yp, zp = vx >= 0, vy >= 0, vz >= 0
    a1 = torch.where(
        zp,
        torch.where(
            xp,
            torch.where(yp, -a1r, a1r),
            torch.where(yp, two_pi + a1r, two_pi - a1r),
        ),
        torch.where(
            xp,
            torch.where(yp, -a1r, a1r),
            torch.where(yp, a1r, -a1r),
        ),
    )
    a2 = torch.where(
        zp,
        torch.where(xp, -a2r, a2r),
        torch.where(xp, math.pi + a2r, math.pi - a2r),
    )
    return a1, a2


def _rot_z(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
         torch.stack([z, z, o], -1)],
        -2,
    )


def _rot_y(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
         torch.stack([-s, z, c], -1)],
        -2,
    )


def _apply(rot: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``pts @ rot.T`` per lane, as explicit sums: rot (B, 3, 3),
    pts (B, ..., 3)."""
    r = rot.reshape(rot.shape[:1] + (1,) * (pts.ndim - 2) + (3, 3))
    return torch.stack(
        [
            pts[..., 0] * r[..., i, 0]
            + pts[..., 1] * r[..., i, 1]
            + pts[..., 2] * r[..., i, 2]
            for i in range(3)
        ],
        -1,
    )


def _z_minimize(rmol, xy, z0, z_lower, z_up, maxiter, active):
    """Window z by the stable L-BFGS-B on ``f(z) = 2 * clearance((xy, z))``
    (reference ``optimise_z``, utilities.py:1174-1188), one lane per
    window, only the ``active`` lanes run; returns (z (L, 1), capped
    (L,))."""
    zero = torch.zeros_like(xy[:, :1])
    x, _, _, _, capped = lbfgsb_stable_flat(
        rmol.coords, rmol.vdw, torch.cat([xy, zero], -1), z0, z_lower,
        z_up, active=active, emb=EMB_Z, sign=1.0, maxiter=maxiter,
    )
    return x, capped


def _window_refine(
    mol: MolArrays,
    vector: torch.Tensor,
    new_z: torch.Tensor,
    active: torch.Tensor,
    cfg: AnalysisConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine the W windows of B frames from their widest sampling rays,
    as B * W optimiser lanes.

    ``mol`` is the pore-centred batch (B, N); ``vector`` (B, W, 3) the
    widest rays; ``new_z`` (B, W) the distance of each ray's narrowest
    point (from the fine re-sampling); ``active`` (B, W) the slots that
    hold a window (the others' results are never read: in "stable" mode
    their optimiser lanes do no work and return placeholders).  Runs in
    :data:`~pywindow_torch.config.OPT_DTYPE` (rotation included) and
    returns (diameter (B, W), centre (B, W, 3), capped (B, W)) in that
    dtype.  In "stable" mode the z and xy stages are the
    ``lbfgsb_stable`` and ``nm_xy`` kernels.
    """
    opt_maxiter, nm_maxiter = effective_budgets(cfg)
    b, n_w = vector.shape[:2]
    n = mol.coords.shape[-2]
    lanes = b * n_w
    mol = mol.to(config.OPT_DTYPE)
    vector = vector.to(config.OPT_DTYPE).reshape(lanes, 3)
    new_z = new_z.to(config.OPT_DTYPE).reshape(lanes)
    active = active.reshape(lanes).contiguous()
    dtype, device = vector.dtype, vector.device

    def per_lane(t):  # (B, N, ...) -> (B * W, N, ...), contiguous for the kernels
        return t[:, None].expand(b, n_w, *t.shape[1:]).reshape(lanes, *t.shape[1:]).contiguous()

    a1, a2 = _octant_angles(vector)
    coords = _apply(_rot_y(a2), _apply(_rot_z(a1), per_lane(mol.coords)))
    lift = torch.stack([torch.zeros_like(new_z), torch.zeros_like(new_z), new_z], -1)
    coords = coords - lift[:, None, :]
    rmol = MolArrays(
        coords, per_lane(mol.mass), per_lane(mol.vdw), per_lane(mol.cov),
        per_lane(mol.mask),
    )

    wd0 = 2.0 * clearance_field(
        torch.zeros((lanes, 1, 3), dtype=dtype, device=device), rmol
    )[:, 0]

    # z minimisation (reference: utilities.py:1299-1305)
    z_lower = (-new_z if cfg.lb_z else torch.full_like(new_z, -1e10))[:, None]
    z_up = torch.full_like(z_lower, 1e10)
    xy0 = torch.zeros((lanes, 2), dtype=dtype, device=device)
    z0 = torch.zeros((lanes, 1), dtype=dtype, device=device)
    zx, capped = _z_minimize(rmol, xy0, z0, z_lower, z_up, opt_maxiter, active)
    z_star = zx[:, 0]

    # xy brute grid + Nelder-Mead polish (utilities.py:1307-1317)
    half = wd0 / 2.0
    # delta space: every candidate as f(p) - f(anchor) through the
    # symbolic-difference form, so the grid argmin and every
    # Nelder-Mead comparison see full-precision differences
    xy_star, _, nm_capped = nm_xy_flat(
        rmol.coords, rmol.vdw, z_star, half, active=active,
        brute_ns=cfg.brute_ns, maxiter=nm_maxiter,
    )
    capped = capped | nm_capped

    if cfg.z_second_mini:
        zx2, capped2 = _z_minimize(rmol, xy_star, zx, z_lower, z_up, opt_maxiter, active)
        z_star = zx2[:, 0]
        capped = capped | capped2

    centre_local = torch.cat([xy_star, z_star[:, None]], -1)
    diameter = 2.0 * clearance_field(centre_local[:, None, :], rmol)[:, 0]

    # reverse the transforms (utilities.py:1338-1360)
    centre = centre_local + lift
    centre = _apply(_rot_z(-a1), _apply(_rot_y(-a2), centre))
    return (
        diameter.reshape(b, n_w),
        centre.reshape(b, n_w, 3),
        capped.reshape(b, n_w),
    )


def find_windows(
    mol: MolArrays,
    n_points: int,
    l1: int,
    l2: int,
    cfg: AnalysisConfig,
    pore_centre: torch.Tensor,
) -> WindowsResult:
    """Full window detection for a batch of B molecules (B, N), in the
    input frame's coordinates; every quantity gains the frame axis.

    ``pore_centre`` (B, 3) is the optimised pore centre the caller
    computed (the reference reruns the same deterministic optimisation
    here, utilities.py:1388); with ``cfg.pore_opt`` off the rays start
    from the centre of mass instead.
    """
    dtype, device = mol.coords.dtype, mol.coords.device
    b = mol.coords.shape[0]
    initial_com = center_of_mass(mol)
    # no interior at the COM -> no pore -> no windows (the reference
    # crashes here on inverted scipy bounds, utilities.py:416-421)
    pd_com, _ = pore_diameter(mol, com=initial_com)
    has_pore = (pd_com > 0.0)[:, None]
    centre = pore_centre if cfg.pore_opt else initial_com

    shifted = mol._replace(coords=mol.coords - centre[:, None, :])
    radius = max_dim_value(shifted) / 2.0
    points = rays.golden_spiral(n_points, radius)  # (B, P, 3)
    eps = rays.mean_knn_eps_scaled(n_points, radius)
    open_pre = rays.preanalysis_open(points, shifted)

    # open-ray compaction, per frame: the coarse sweep and DBSCAN only
    # consume rays the pre-analysis left open, so they run on the first
    # K open rays in spiral order (slot s takes the (s+1)-th open ray,
    # found by a search of the running open count: no host sync); every
    # later quantity depends only on relative order, so results equal
    # the full-spiral path whenever the open count fits the cap, and
    # overflow is flagged for the host's re-run.  Empty slots are zero
    # rays, as the JAX package's one-hot compaction leaves them.
    kcap = open_cap(n_points, cfg.open_cap_frac)
    if kcap is None:
        cpoints = points
        path = rays.path_analysis(points, shifted, cfg.increment, l1)
        survives = open_pre & path.ok & has_pore
        overflow = torch.zeros(b, dtype=torch.bool, device=device)
    else:
        count = torch.cumsum(open_pre.to(torch.int64), -1)
        n_open = count[:, -1]
        overflow = n_open > kcap
        slot = torch.arange(kcap, device=device)
        targets = (slot + 1).expand(b, kcap).contiguous()
        src = torch.searchsorted(count, targets).clamp_max(n_points - 1)
        slot_valid = slot[None, :] < n_open[:, None]
        picked = points.gather(1, src[..., None].expand(-1, -1, 3))
        cpoints = torch.where(slot_valid[..., None], picked, 0.0)
        path = rays.path_analysis(cpoints, shifted, cfg.increment, l1)
        survives = slot_valid & path.ok & has_pore
    any_open = survives.any(-1)

    labels, n_clusters = dbscan(
        cpoints,
        survives,
        eps,
        min_samples=cfg.dbscan_min_samples,
        max_clusters=cfg.max_windows,
    )

    # empty window slots refine any valid surviving ray instead of a
    # garbage vector (the stable optimiser lanes skip them outright; the
    # classic drivers stop early there)
    fallback_sel = torch.where(survives, path.width, -BIG).argmax(-1)

    # widest-ray selection + fine 0.1 Å re-sampling for all W slots
    w_ids = torch.arange(cfg.max_windows, dtype=torch.int32, device=device)
    in_cluster = labels[:, None, :] == w_ids[None, :, None]  # (B, W, K)
    width_masked = torch.where(in_cluster, path.width[:, None, :], -BIG)
    exists = (w_ids[None, :] < n_clusters[:, None]) & in_cluster.any(-1)
    sel = torch.where(exists, width_masked.argmax(-1), fallback_sel[:, None])
    vectors = cpoints.gather(1, sel[..., None].expand(-1, -1, 3))  # (B, W, 3)
    # only the slots that hold a window are walked (their results are the
    # only ones read below); the others hold fine_path's placeholders
    refined = rays.fine_path_analysis(
        vectors, shifted, cfg.increment2, l2, active=exists.contiguous()
    )

    diams, centres, w_capped = _window_refine(
        shifted, vectors, refined.dist, exists, cfg
    )
    diams, centres = diams.to(dtype), centres.to(dtype)
    failed = exists & ~refined.ok
    valid = exists & ~failed
    centres = centres + centre[:, None, :]
    # budget escalation: only real window slots count
    opt_capped = (exists & w_capped).any(-1)
    return WindowsResult(
        diameters=torch.where(valid, diams, math.nan),
        centers=torch.where(valid[..., None], centres, math.nan),
        valid=valid,
        any_open=any_open,
        n_clusters=n_clusters,
        refine_failed=failed,
        open_overflow=overflow,
        opt_capped=opt_capped,
    )
