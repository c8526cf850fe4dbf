"""Nelder–Mead and the brute-grid start of the window xy stage
(counterpart of ``pywindow_tpu.ops.optim``).

The reference polishes the window centre in xy with
``scipy.optimize.brute(..., finish=fmin)`` (reference:
utilities.py:1312-1317).  Both functions here run B independent lanes
(leading axis); ``f_batch`` maps (B, K, d) points to (B, K) values.  The
Nelder–Mead loop runs while any lane is live, and a lane that has
stopped keeps its simplex (vmap-of-while semantics).
"""

from __future__ import annotations

from typing import Callable

import torch

from portbench.reference.frozen.rays import linspace

# scipy Nelder-Mead standard coefficients (non-adaptive).
_RHO = 1.0  # reflection
_CHI = 2.0  # expansion
_PSI = 0.5  # contraction
_SIGMA = 0.5  # shrink
_NONZDELT = 0.05
_ZDELT = 0.00025


def scipy_default_step(x0: torch.Tensor) -> torch.Tensor:
    """scipy fmin's initial-simplex displacement rule per coordinate."""
    return torch.where(x0 != 0.0, _NONZDELT * x0, _ZDELT)


def _sort_simplex(sim, fsim):
    """Stable sort of the vertices by f (ties keep their order, as the
    JAX package's compare/select network and scipy's argsort do)."""
    fsim, order = torch.sort(fsim, dim=-1, stable=True)
    return sim.gather(-2, order[..., None].expand_as(sim)), fsim


def nelder_mead(
    f_batch: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lower: torch.Tensor | None = None,
    upper: torch.Tensor | None = None,
    xatol: float = 1e-8,
    fatol: float = 1e-12,
    maxiter: int = 400,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimise per lane with the scipy fmin update rules.

    x0: (B, d); the initial simplex follows scipy fmin's rule.
    ``lower``/``upper`` (B, d) clip every proposed vertex into the box.
    Every candidate of one iteration (reflection, expansion, both
    contractions, the shrunk vertices) is evaluated in one ``f_batch``
    call; the branch decisions are scipy's.  Returns
    ``(x_best (B, d), f_best (B,), capped (B,))`` with ``capped`` True
    where the iteration budget, not convergence, stopped the lane.
    """
    d = x0.shape[-1]

    def clip(x):
        if lower is not None:
            x = torch.maximum(x, lower[:, None, :])
        if upper is not None:
            x = torch.minimum(x, upper[:, None, :])
        return x

    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    step = scipy_default_step(x0)
    sim = torch.cat([x0[:, None, :], x0[:, None, :] + eye * step[:, None, :]], 1)
    sim = clip(sim)
    sim, fsim = _sort_simplex(sim, f_batch(sim))

    def converged(sim, fsim):
        x_spread = (sim[:, 1:] - sim[:, :1]).abs().amax((-2, -1))
        f_spread = (fsim[:, 1:] - fsim[:, :1]).abs().amax(-1)
        return (x_spread <= xatol) & (f_spread <= fatol)

    it = torch.zeros(x0.shape[0], dtype=torch.int64, device=x0.device)
    while True:
        run = (it < maxiter) & ~converged(sim, fsim)
        if not bool(run.any()):
            break
        xbar = sim[:, :-1].mean(1)
        worst = sim[:, -1]
        cand = clip(
            torch.stack(
                [
                    (1.0 + _RHO) * xbar - _RHO * worst,
                    (1.0 + _RHO * _CHI) * xbar - _RHO * _CHI * worst,
                    (1.0 + _PSI * _RHO) * xbar - _PSI * _RHO * worst,
                    (1.0 - _PSI) * xbar + _PSI * worst,
                ],
                1,
            )
        )
        shrunk = clip(sim[:, :1] + _SIGMA * (sim - sim[:, :1]))
        # one evaluation of every point this iteration could need
        fc = f_batch(torch.cat([cand, shrunk[:, 1:]], 1))
        fxr, fxe, fxc, fxcc = fc[:, 0], fc[:, 1], fc[:, 2], fc[:, 3]
        shrunk_f = torch.cat([fsim[:, :1], fc[:, 4:]], 1)

        best = fxr < fsim[:, 0]
        good = fxr < fsim[:, -2]
        worse = fxr < fsim[:, -1]
        use_xe = best & (fxe < fxr)
        need_xc = ~best & ~good & worse
        need_xcc = ~best & ~good & ~worse
        accept_xc = need_xc & (fxc <= fxr)
        accept_xcc = need_xcc & (fxcc < fsim[:, -1])
        # unresolved contractions shrink the simplex towards the best
        shrink = (need_xc & ~accept_xc) | (need_xcc & ~accept_xcc)

        pick = torch.where(
            use_xe, 1, torch.where(accept_xc, 2, torch.where(accept_xcc, 3, 0))
        )
        new_last = cand.gather(1, pick[:, None, None].expand(-1, 1, d))
        new_flast = fc.gather(1, pick[:, None])
        replaced = torch.cat([sim[:, :-1], new_last], 1)
        replaced_f = torch.cat([fsim[:, :-1], new_flast], 1)
        new_sim, new_f = _sort_simplex(
            torch.where(shrink[:, None, None], shrunk, replaced),
            torch.where(shrink[:, None], shrunk_f, replaced_f),
        )
        sim = torch.where(run[:, None, None], new_sim, sim)
        fsim = torch.where(run[:, None], new_f, fsim)
        it = torch.where(run, it + 1, it)
    # budget-stopped (a larger maxiter would keep iterating): drives the
    # fast-budget escalation retry
    capped = (it >= maxiter) & ~converged(sim, fsim)
    return sim[:, 0], fsim[:, 0], capped


def brute_start(
    f_batch: Callable[[torch.Tensor], torch.Tensor],
    lower: torch.Tensor,
    upper: torch.Tensor,
    ns: int,
) -> torch.Tensor:
    """The dense-grid argmin that seeds the polish (scipy ``brute``'s
    grid pass, endpoints included, x outer, first minimum on ties;
    reference: utilities.py:1312-1314).  lower/upper: (B, 2)."""
    dtype, device = lower.dtype, lower.device
    gx = linspace(lower[:, 0], upper[:, 0], ns, dtype, device)  # (B, ns)
    gy = linspace(lower[:, 1], upper[:, 1], ns, dtype, device)
    grid = torch.stack(
        [gx.repeat_interleave(ns, dim=1), gy.repeat(1, ns)], -1
    )  # (B, ns*ns, 2), row-major like np.mgrid
    best = f_batch(grid).argmin(-1)
    return grid.gather(1, best[:, None, None].expand(-1, 1, 2))[:, 0]


def brute_then_polish(
    f_batch: Callable[[torch.Tensor], torch.Tensor],
    lower: torch.Tensor,
    upper: torch.Tensor,
    ns: int,
    maxiter: int = 400,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``scipy.optimize.brute(..., Ns=ns, finish=fmin)``: the grid
    argmin, then a Nelder–Mead polish from it with scipy's default
    simplex and fmin's default tolerances.  Returns
    ``(x_best, f_best, capped)``."""
    x0 = brute_start(f_batch, lower, upper, ns)
    return nelder_mead(f_batch, x0, xatol=xatol, fatol=fatol, maxiter=maxiter)
