"""The ``nm_xy`` kernel: the window-xy brute grid and Nelder–Mead polish
per lane (counterpart of ``pywindow_tpu.ops.nm_pallas.nm_xy_flat`` with
``brute_ns > 0``).

- :func:`nm_xy_flat_plain`: the plain version, the port's
  :func:`pywindow_torch.ops.optim.brute_then_polish` with the stable
  delta-space objective ``f(x, y) = -2 * (clearance((x, y, z*)) -
  clearance((0, 0, z*)))`` (windows.py:232-251 of the port before this
  kernel);
- :func:`nm_xy_flat_cuda`: the wrapper of ``csrc/nm_xy.cu``;
- :func:`nm_xy_flat`: the entry point, by the device of ``coords``.

Lanes are (frame, window) pairs: coords (L, N, 3) rotated molecules
with padded atoms at ``FAR_AWAY`` and vdW 0, vdw (L, N), zanchor (L,)
the window z*, half (L,) the grid half-width, all float64.  Returns
``(xy (L, 2), f (L,), capped (L,))``.
"""

from __future__ import annotations

import torch

from pywindow_torch.ops import _cuda
from pywindow_torch.ops.encoding import unmasked
from pywindow_torch.ops.geometry import clearance_diff
from pywindow_torch.ops.optim import brute_then_polish


def nm_xy_flat_plain(
    coords: torch.Tensor,
    vdw: torch.Tensor,
    zanchor: torch.Tensor,
    half: torch.Tensor,
    *,
    brute_ns: int = 20,
    maxiter: int = 400,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
):
    """scipy ``brute(..., Ns=brute_ns, finish=fmin)`` over
    [-half, half]^2 per lane, in delta space (see the module docstring)."""
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


def nm_xy_flat_cuda(
    coords: torch.Tensor,
    vdw: torch.Tensor,
    zanchor: torch.Tensor,
    half: torch.Tensor,
    *,
    brute_ns: int = 20,
    maxiter: int = 400,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
):
    """:func:`nm_xy_flat_plain` through the CUDA kernel
    (``csrc/nm_xy.cu``); float64 only."""
    name = "nm_xy"
    device = _cuda.check_inputs(
        name, torch.float64, coords=coords, vdw=vdw, zanchor=zanchor, half=half
    )
    if coords.ndim != 3:
        msg = f"{name}: coords must be (L, N, 3), got {coords.shape}"
        raise ValueError(msg)
    lanes, n = coords.shape[0], coords.shape[1]
    _cuda.check_shape(name, coords, (lanes, n, 3), "coords")
    _cuda.check_shape(name, vdw, (lanes, n), "vdw")
    _cuda.check_shape(name, zanchor, (lanes,), "zanchor")
    _cuda.check_shape(name, half, (lanes,), "half")
    if brute_ns < 1:
        msg = f"{name}: brute_ns={brute_ns} must be >= 1"
        raise ValueError(msg)
    _cuda.check_smem(name, 6 * n * 8)
    xy = torch.empty((lanes, 2), dtype=torch.float64, device=device)
    f = torch.empty(lanes, dtype=torch.float64, device=device)
    capped = torch.empty(lanes, dtype=torch.bool, device=device)
    _cuda.load_extension().nm_xy(
        coords, vdw, zanchor, half, xy, f, capped, int(brute_ns), int(maxiter),
        float(xatol), float(fatol),
    )
    _cuda.LAUNCHES["nm_xy"] += 1
    return xy, f, capped


def nm_xy_flat(coords, vdw, zanchor, half, **kwargs):
    """Window-xy brute grid + Nelder–Mead per lane; see
    :func:`nm_xy_flat_plain`."""
    if _cuda.device_type("nm_xy", coords) == "cuda":
        return nm_xy_flat_cuda(coords, vdw, zanchor, half, **kwargs)
    return nm_xy_flat_plain(coords, vdw, zanchor, half, **kwargs)
