"""The ``nm_xy`` kernel: the window-xy brute grid and Nelder–Mead polish
per lane (counterpart of ``pywindow_tpu.ops.nm_pallas.nm_xy_flat`` with
``brute_ns > 0``).

- :func:`nm_xy_flat_plain`: the plain version, the port's
  :func:`pywindow_torch.ops.optim.brute_then_polish` with the stable
  delta-space objective ``f(x, y) = -2 * (clearance((x, y, z*)) -
  clearance((0, 0, z*)))`` (windows.py:232-251 of the port before this
  kernel);
- :func:`nm_xy_flat_cuda`: the wrapper of ``csrc/nm_xy.cu``;
- :func:`nm_xy_flat`: the entry point, by the device of ``coords``;
- :func:`grid_keep`: the atoms the kernel's grid phase keeps (its exact
  cull, mirrored here for the tests and the measurements).

Lanes are (frame, window) pairs: coords (L, N, 3) rotated molecules
with padded atoms at ``FAR_AWAY`` and vdW 0, vdw (L, N), zanchor (L,)
the window z*, half (L,) the grid half-width, all float64, and
optionally ``active`` (L,) bool: an inactive lane does no work and
returns the placeholder ``((0, 0), 0, False)``.  Returns
``(xy (L, 2), f (L,), capped (L,))``.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen import _cuda
from portbench.reference.frozen.encoding import unmasked
from portbench.reference.frozen.geometry import clearance_diff
from portbench.reference.frozen.optim import brute_then_polish
from portbench.reference.frozen.rays import linspace

#: the cull's margin (Å): far above the rounding of the symbolic-difference
#: form at these magnitudes (~1e-14 Å), far below any atom's reach
CULL_EPS = 1e-9
#: the most atoms of the subset whose grid pass tightens the cull's bound
CULL_SUBSET = 16
#: the subset's widths over min(hi), widest first (Å)
CULL_WIDTHS = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.0)


def _grid_points(half: torch.Tensor, ns: int) -> torch.Tensor:
    """(L, ns * ns, 2): the brute grid over [-half, half]^2, x outer, as
    :func:`~pywindow_torch.ops.optim.brute_start` lays it out."""
    g = linspace(-half, half, ns, half.dtype, half.device)
    return torch.stack([g.repeat_interleave(ns, dim=1), g.repeat(1, ns)], -1)


def grid_keep(
    coords: torch.Tensor,
    vdw: torch.Tensor,
    zanchor: torch.Tensor,
    half: torch.Tensor,
    brute_ns: int = 20,
) -> torch.Tensor:
    """(L, N) bool: the atoms that can set a grid value, by the rule
    ``csrc/nm_xy.cu`` applies (its source has the derivation).

    With ``d = (0, 0, z*) - a``, ``lo_a``/``hi_a`` the least/greatest
    distance from atom a to the grid's square |x|, |y| <= half at z*
    less its vdW radius, and v_a(p) its value at grid point p: the
    grid's best value is at most ``min_b(hi_b) - m0 + eps`` and at most
    ``max_p min_{a in A} v_a(p)`` for the subset A of atoms with ``hi``
    within the widest of :data:`CULL_WIDTHS` of ``min_b(hi_b)`` that
    holds at most :data:`CULL_SUBSET` atoms; an atom whose ``lo_a`` lies
    2 eps beyond the smaller bound (plus m0) is never the minimising atom
    at any grid point, so every grid value is the same without it."""
    d0 = 0.0 - coords[..., 0]
    d1 = 0.0 - coords[..., 1]
    d2 = zanchor[:, None] - coords[..., 2]
    h = half[:, None]
    ex = torch.clamp_min(d0.abs() - h, 0.0)
    ey = torch.clamp_min(d1.abs() - h, 0.0)
    fx = d0.abs() + h
    fy = d1.abs() + h
    lo = torch.sqrt(ex * ex + ey * ey + d2 * d2) - vdw
    hi = torch.sqrt(fx * fx + fy * fy + d2 * d2) - vdw
    hi_min = hi.amin(-1, keepdim=True)
    bound = hi_min + 2.0 * CULL_EPS
    # the subset A: per lane the widest width holding <= CULL_SUBSET atoms
    widths = torch.tensor(CULL_WIDTHS, dtype=hi.dtype, device=hi.device)
    counts = (hi[:, None, :] <= hi_min[:, :, None] + widths[None, :, None]).sum(-1)
    fits = counts <= CULL_SUBSET
    has = fits.any(-1)
    width = widths[fits.to(torch.int64).argmax(-1)]  # first fitting = widest
    in_a = (hi <= hi_min + width[:, None]) & has[:, None]
    # A's atoms gathered (padded slots masked) and their grid maximum
    order = torch.sort((~in_a).to(torch.int8), dim=-1, stable=True).indices[:, :CULL_SUBSET]
    slot_ok = in_a.gather(1, order)

    def take(t):
        return t.gather(1, order)

    db2 = d0 * d0 + d1 * d1 + d2 * d2
    db = torch.sqrt(db2)
    m0 = (db - vdw).amin(-1, keepdim=True)
    base = (take(db) - take(vdw)) - m0
    grid = _grid_points(half, brute_ns)
    u0, u1 = grid[..., 0:1], grid[..., 1:2]  # (L, P, 1)
    g = u0 * take(d0)[:, None, :] + u1 * take(d1)[:, None, :] + 0.0 * take(d2)[:, None, :]
    s2 = u0 * u0 + u1 * u1 + 0.0 * 0.0
    num = 2.0 * g + s2
    dp = torch.sqrt(torch.clamp_min(take(db2)[:, None, :] + num, 0.0))
    den = take(db)[:, None, :] + dp
    value = base[:, None, :] + num / torch.where(den == 0.0, 1.0, den)
    f_a = torch.where(slot_ok[:, None, :], value, 1e30).amin(-1)  # (L, P)
    tight = (f_a.amax(-1, keepdim=True) + m0) + 2.0 * CULL_EPS
    bound = torch.where(has[:, None], torch.minimum(bound, tight), bound)
    return lo <= bound


def _placeholders(lanes: int, like: torch.Tensor) -> tuple:
    """What an inactive lane returns: xy (0, 0), f 0, not capped."""
    return (
        torch.zeros((lanes, 2), dtype=like.dtype, device=like.device),
        torch.zeros(lanes, dtype=like.dtype, device=like.device),
        torch.zeros(lanes, dtype=torch.bool, device=like.device),
    )


def nm_xy_flat_plain(
    coords: torch.Tensor,
    vdw: torch.Tensor,
    zanchor: torch.Tensor,
    half: torch.Tensor,
    *,
    active: torch.Tensor | None = None,
    brute_ns: int = 20,
    maxiter: int = 400,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
):
    """scipy ``brute(..., Ns=brute_ns, finish=fmin)`` over
    [-half, half]^2 per lane, in delta space (see the module docstring);
    with ``active``, only the active lanes run."""

    def run(coords, vdw, zanchor, half):
        mol = unmasked(coords, vdw)
        zero = torch.zeros_like(zanchor)
        anchor = torch.stack([zero, zero, zanchor], -1)

        def f_xy(xys):  # (L, K, 2) -> (L, K)
            disp = torch.cat([xys, torch.zeros_like(xys[..., :1])], -1)
            return -2.0 * clearance_diff(anchor, disp, mol)

        return brute_then_polish(
            f_xy,
            torch.stack([-half, -half], -1),
            torch.stack([half, half], -1),
            ns=brute_ns,
            maxiter=maxiter,
            xatol=xatol,
            fatol=fatol,
        )

    return _cuda.on_active_lanes(
        active, run, (coords, vdw, zanchor, half), _placeholders(coords.shape[0], coords)
    )


def nm_xy_flat(coords, vdw, zanchor, half, **kwargs):
    """Window-xy brute grid + Nelder–Mead per lane; see
    :func:`nm_xy_flat_plain`."""
    return nm_xy_flat_plain(coords, vdw, zanchor, half, **kwargs)
