"""The ``lbfgsb_stable`` kernel: the whole stable L-BFGS-B per lane
(counterpart of ``pywindow_tpu.ops.lbfgsb_pallas.lbfgsb_stable_flat``).

- :func:`lbfgsb_stable_flat_plain`: the plain version, the port's own
  driver :func:`pywindow_torch.ops.lbfgsb.lbfgsb_minimize_stable` fed by
  symbolic-difference probes of ``sign * 2 * clearance`` through a static
  axis embedding (lbfgsb_pallas.py:188-200): the probed point is
  ``origin + emb(u)``, with ``EMB_XYZ`` (d = 3, the pore centre) or
  ``EMB_Z`` (d = 1, the window z);
- :func:`lbfgsb_stable_flat_cuda`: the wrapper of ``csrc/lbfgsb_stable.cu``;
- :func:`lbfgsb_stable_flat`: the entry point, by the device of
  ``coords``, with no fallback.

Inputs are flat lane batches: coords (B, N, 3) with padded atoms at
``FAR_AWAY`` and vdW 0, vdw (B, N), origin (B, 3), x0/lower/upper
(B, d), all float64 (:data:`~pywindow_torch.config.OPT_DTYPE`), and
optionally ``active`` (B,) bool: an inactive lane does no work and
returns the placeholder ``(x0, 0, 0, False, False)``.
Returns ``(x (B, d), fun (B,), nit (B,) int32, converged (B,),
capped (B,))``.
"""

from __future__ import annotations

import torch

from pywindow_torch.ops import _cuda
from pywindow_torch.ops.encoding import unmasked
from pywindow_torch.ops.geometry import clearance_diff, clearance_field
from pywindow_torch.ops.lbfgsb import _FD_ABS_STEP, _M, lbfgsb_minimize_stable

#: identity embedding (pore stage, d = 3).
EMB_XYZ = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
#: z-axis embedding (window-z stage, d = 1).
EMB_Z = ((0.0, 0.0, 1.0),)
_EMBEDDINGS = (EMB_XYZ, EMB_Z)
#: the kernel's history capacity (scipy's maxcor default)
MAX_M = 10


def _embed(s: torch.Tensor, emb: tuple) -> torch.Tensor:
    """u-space displacement (..., d) -> 3-D displacement (..., 3)."""
    if emb == EMB_XYZ:
        return s
    zero = torch.zeros_like(s[..., 0])
    return torch.stack([zero, zero, s[..., 0]], -1)


def _check_emb(emb: tuple, d: int) -> None:
    if emb not in _EMBEDDINGS or len(emb) != d:
        msg = f"lbfgsb_stable: embedding {emb} with d={d} (EMB_XYZ with d=3 or EMB_Z with d=1)"
        raise ValueError(msg)


def _placeholders(x0: torch.Tensor) -> tuple:
    """What an inactive lane returns: its start, 0, 0 iterations, not
    converged, not capped."""
    b = x0.shape[0]
    return (
        x0.clone(),
        torch.zeros(b, dtype=x0.dtype, device=x0.device),
        torch.zeros(b, dtype=torch.int32, device=x0.device),
        torch.zeros(b, dtype=torch.bool, device=x0.device),
        torch.zeros(b, dtype=torch.bool, device=x0.device),
    )


def lbfgsb_stable_flat_plain(
    coords: torch.Tensor,
    vdw: torch.Tensor,
    origin: torch.Tensor,
    x0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    active: torch.Tensor | None = None,
    emb: tuple = EMB_XYZ,
    sign: float = -1.0,
    maxiter: int = 50,
    m: int = _M,
    maxls: int = 20,
    pgtol: float = 1e-5,
    factr: float = 1e7,
    fd_step: float = _FD_ABS_STEP,
):
    """The stable L-BFGS-B over B lanes as plain tensor code (see the
    module docstring); with ``active``, only the active lanes run."""
    _check_emb(emb, x0.shape[-1])
    sign2 = sign * 2.0

    def run(coords, vdw, origin, x0, lower, upper):
        mol = unmasked(coords, vdw)

        def point3(u):
            return origin + _embed(u, emb)

        def probe(x, disp, h):
            delta = clearance_diff(point3(x), _embed(disp, emb)[:, None, :], mol)[:, 0]
            steps = _embed(torch.diag_embed(h), emb)  # (B, d, 3)
            dprobe = clearance_diff(point3(x + disp), steps, mol)
            return sign2 * delta, (sign2 * dprobe) / h

        def f_abs(x):
            return sign2 * clearance_field(point3(x)[:, None, :], mol)[:, 0]

        res = lbfgsb_minimize_stable(
            probe, f_abs, x0, lower, upper, m=m, maxiter=maxiter, pgtol=pgtol,
            factr=factr, maxls=maxls, fd_step=fd_step,
        )
        return res.x, res.fun, res.nit.to(torch.int32), res.converged, res.capped

    return _cuda.on_active_lanes(
        active, run, (coords, vdw, origin, x0, lower, upper), _placeholders(x0)
    )


def lane_launch(lanes: int, n: int, sms: int) -> tuple[int, bool]:
    """(threads of one lane's block, register cap) for ``lanes`` lanes of
    ``n`` atoms on a card of ``sms`` SMs, as measured on the H100
    (PERF.md, ``optim_kernel_report.py``): up to 4 lanes an SM take 4
    warps each, 8 beyond 256 atoms, so that a lane's atoms spread over
    the block (a PUDXES lane: 1-2 atoms a thread); a larger batch, which
    would not fit one wave of those (a wider lane needs 230-255
    registers a thread, 2 blocks an SM), takes one warp a lane held to
    170 registers a thread, 12 lanes an SM in flight."""
    if lanes > 4 * sms:
        return 32, True
    return (256 if n > 256 else 128), False


def lbfgsb_stable_flat_cuda(
    coords: torch.Tensor,
    vdw: torch.Tensor,
    origin: torch.Tensor,
    x0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    *,
    active: torch.Tensor | None = None,
    emb: tuple = EMB_XYZ,
    sign: float = -1.0,
    maxiter: int = 50,
    m: int = _M,
    maxls: int = 20,
    pgtol: float = 1e-5,
    factr: float = 1e7,
    fd_step: float = _FD_ABS_STEP,
):
    """:func:`lbfgsb_stable_flat_plain` through the CUDA kernel
    (``csrc/lbfgsb_stable.cu``); float64 only."""
    name = "lbfgsb_stable"
    device = _cuda.check_inputs(
        name, torch.float64, coords=coords, vdw=vdw, origin=origin, x0=x0,
        lower=lower, upper=upper, **({} if active is None else {"active": active}),
    )
    if coords.ndim != 3 or x0.ndim != 2:
        msg = f"{name}: coords (B, N, 3) and x0 (B, d), got {coords.shape}, {x0.shape}"
        raise ValueError(msg)
    b, n, d = coords.shape[0], coords.shape[1], x0.shape[1]
    _check_emb(emb, d)
    _cuda.check_shape(name, coords, (b, n, 3), "coords")
    _cuda.check_shape(name, vdw, (b, n), "vdw")
    _cuda.check_shape(name, origin, (b, 3), "origin")
    for key, t in (("lower", lower), ("upper", upper)):
        _cuda.check_shape(name, t, (b, d), key)
    _cuda.check_active(name, active, b)
    if not 1 <= m <= MAX_M:
        msg = f"{name}: m={m} outside 1..{MAX_M}"
        raise ValueError(msg)
    _cuda.check_smem(name, 4 * n * 8 + 4096)
    x = torch.empty((b, d), dtype=torch.float64, device=device)
    fun = torch.empty(b, dtype=torch.float64, device=device)
    nit = torch.empty(b, dtype=torch.int32, device=device)
    conv = torch.empty(b, dtype=torch.bool, device=device)
    capped = torch.empty(b, dtype=torch.bool, device=device)
    _cuda.load_extension().lbfgsb_stable(
        coords, vdw, origin, x0, lower, upper, active, x, fun, nit, conv, capped,
        float(sign), int(maxiter), int(m), int(maxls), float(pgtol),
        float(factr), float(fd_step), *lane_launch(b, n, _cuda.sm_count(device)),
    )
    _cuda.count_launch("lbfgsb_stable")
    return x, fun, nit, conv, capped


def lbfgsb_stable_flat(coords, vdw, origin, x0, lower, upper, **kwargs):
    """The stable L-BFGS-B over B lanes; see :func:`lbfgsb_stable_flat_plain`."""
    if _cuda.device_type("lbfgsb_stable", coords) == "cuda":
        return lbfgsb_stable_flat_cuda(coords, vdw, origin, x0, lower, upper, **kwargs)
    return lbfgsb_stable_flat_plain(coords, vdw, origin, x0, lower, upper, **kwargs)
