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

from portbench.reference.frozen import _cuda
from portbench.reference.frozen.encoding import unmasked
from portbench.reference.frozen.geometry import clearance_field, pore_stable_probe
from portbench.reference.frozen.lbfgsb import _FD_ABS_STEP, _M, lbfgsb_minimize_stable

#: identity embedding (pore stage, d = 3).
EMB_XYZ = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
#: z-axis embedding (window-z stage, d = 1).
EMB_Z = ((0.0, 0.0, 1.0),)
_EMBEDDINGS = (EMB_XYZ, EMB_Z)


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

        probe = pore_stable_probe(mol, sign, origin, lambda s: _embed(s, emb))

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


def lbfgsb_stable_flat(coords, vdw, origin, x0, lower, upper, **kwargs):
    """The stable L-BFGS-B over B lanes; see :func:`lbfgsb_stable_flat_plain`."""
    return lbfgsb_stable_flat_plain(coords, vdw, origin, x0, lower, upper, **kwargs)
