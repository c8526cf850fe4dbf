"""Batched bounded minimiser reproducing scipy's L-BFGS-B stopping
behaviour (counterpart of ``pywindow_tpu.ops.lbfgsb``).

The reference optimises the pore centre and the window z coordinate
with ``scipy.optimize.minimize(..., bounds=...)`` (L-BFGS-B, 2-point FD
gradients, the Moré–Thuente ``dcsrch``/``dcstep`` line search;
reference: utilities.py:400-426, :1301-1305).  The objectives are
piecewise-smooth clearance fields, so where the optimiser stops on a
kink ridge depends on those algorithmic details; golden parity needs
them reproduced.  The JAX package's module docstring (lbfgsb.py:1-43)
lists each rule; this module ports every one of them:

* scipy-exact 2-point FD gradients with the 1-sided bound adjustment,
* the generalized Cauchy point and the 3.0 ``subsm`` subspace step,
* ``dcsrch`` with ``ftol=1e-3, gtol=0.9, xtol=0.1`` and the ``lnsrlb``
  step rules,
* the ``mainlb`` restart machinery, curvature skip rule and
  ``theta = y'y / y's`` scaling, ``pgtol`` and ``factr`` termination.

Batching: every function works on B independent lanes (leading axis),
as ``vmap`` did in the JAX package.  Each ``while_loop`` became a Python
loop that runs while any lane is live; a lane whose own condition is
false keeps its state (vmap-of-while semantics), in the nested line
search as well as in the outer iteration.  So each lane stops exactly
where it would alone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# dcsrch parameters as used by L-BFGS-B.
_FTOL = 1e-3
_GTOL = 0.9
_XTOL = 0.1
_XTRAPL = 1.1
_XTRAPU = 4.0
_EPS64 = 2.220446049250313e-16
# scipy _minimize_lbfgsb default FD step (absolute; jac=None path).
_FD_ABS_STEP = 1e-8
_M = 10  # scipy maxcor default


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where`` with a per-lane (B,) mask broadcast over a's trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)), a, b)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fixed-association small dot product over the trailing axis
    (``a0*b0 + a1*b1 + ...``), identical on every device."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., d, d) · (..., d) via :func:`_dot` rows."""
    return torch.stack([_dot(a[..., i, :], v) for i in range(a.shape[-1])], -1)


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


class _StepState(NamedTuple):
    stx: torch.Tensor
    fx: torch.Tensor
    dx: torch.Tensor
    sty: torch.Tensor
    fy: torch.Tensor
    dy: torch.Tensor
    stp: torch.Tensor
    brackt: torch.Tensor


def _select_state(mask, a: NamedTuple, b: NamedTuple):
    return type(a)(*(_sel(mask, x, y) for x, y in zip(a, b)))


def _safe_div(p, q):
    # 1e-300 is exact in float64 (scipy parity) and flushes to 0.0 in
    # float32, as in the JAX package
    return p / torch.where(q == 0.0, 1e-300, q)


def _cubic_gamma(theta, da, db, flip):
    s = torch.maximum(torch.maximum(theta.abs(), da.abs()), db.abs())
    g = s * torch.sqrt(
        torch.clamp_min((theta / s) ** 2 - (da / s) * (db / s), 0.0)
    )
    return torch.where(flip, -g, g)


def _dcstep(st: _StepState, fp, dp, stpmin, stpmax) -> _StepState:
    """MINPACK-2 dcstep: trial-step update via cubic/quadratic models."""
    stx, fx, dx, sty, fy, dy, stp, brackt = st
    sgnd = dp * torch.sign(dx)

    # case 1: higher function value
    theta1 = 3.0 * (fx - fp) * _safe_div(1.0, stp - stx) + dx + dp
    gamma1 = _cubic_gamma(theta1, dx, dp, stp < stx)
    p1 = (gamma1 - dx) + theta1
    q1 = ((gamma1 - dx) + gamma1) + dp
    stpc1 = stx + _safe_div(p1, q1) * (stp - stx)
    stpq1 = stx + (
        _safe_div(dx, _safe_div(fx - fp, stp - stx) + dx) / 2.0
    ) * (stp - stx)
    stpf1 = torch.where(
        (stpc1 - stx).abs() < (stpq1 - stx).abs(),
        stpc1,
        stpc1 + (stpq1 - stpc1) / 2.0,
    )

    # case 2: lower value, opposite derivative sign
    gamma2 = _cubic_gamma(theta1, dx, dp, stp > stx)
    p2 = (gamma2 - dp) + theta1
    q2 = ((gamma2 - dp) + gamma2) + dx
    stpc2 = stp + _safe_div(p2, q2) * (stx - stp)
    stpq2 = stp + _safe_div(dp, dp - dx) * (stx - stp)
    stpf2 = torch.where(
        (stpc2 - stp).abs() > (stpq2 - stp).abs(), stpc2, stpq2
    )

    # case 3: lower value, same sign, decreasing magnitude
    gamma3 = _cubic_gamma(theta1, dx, dp, stp > stx)
    p3 = (gamma3 - dp) + theta1
    q3 = (gamma3 + (dx - dp)) + gamma3
    r3 = _safe_div(p3, q3)
    stpc3 = torch.where(
        (r3 < 0.0) & (gamma3 != 0.0),
        stp + r3 * (stx - stp),
        torch.where(stp > stx, stpmax, stpmin),
    )
    stpq3 = stp + _safe_div(dp, dp - dx) * (stx - stp)
    stpf3_brackt = torch.where(
        (stpc3 - stp).abs() < (stpq3 - stp).abs(), stpc3, stpq3
    )
    stpf3_brackt = torch.where(
        stp > stx,
        torch.minimum(stp + 0.66 * (sty - stp), stpf3_brackt),
        torch.maximum(stp + 0.66 * (sty - stp), stpf3_brackt),
    )
    stpf3_free = torch.where(
        (stpc3 - stp).abs() > (stpq3 - stp).abs(), stpc3, stpq3
    )
    stpf3_free = torch.minimum(torch.maximum(stpf3_free, stpmin), stpmax)
    stpf3 = torch.where(brackt, stpf3_brackt, stpf3_free)

    # case 4: lower value, same sign, not decreasing
    theta4 = 3.0 * (fp - fy) * _safe_div(1.0, sty - stp) + dy + dp
    gamma4 = _cubic_gamma(theta4, dy, dp, stp > sty)
    p4 = (gamma4 - dp) + theta4
    q4 = ((gamma4 - dp) + gamma4) + dy
    stpc4 = stp + _safe_div(p4, q4) * (sty - stp)
    stpf4 = torch.where(
        brackt, stpc4, torch.where(stp > stx, stpmax, stpmin)
    )

    case1 = fp > fx
    case2 = ~case1 & (sgnd < 0.0)
    case3 = ~case1 & ~case2 & (dp.abs() < dx.abs())
    stpf = torch.where(
        case1,
        stpf1,
        torch.where(case2, stpf2, torch.where(case3, stpf3, stpf4)),
    )
    opposite = sgnd < 0.0
    return _StepState(
        stx=torch.where(case1, stx, stp),
        fx=torch.where(case1, fx, fp),
        dx=torch.where(case1, dx, dp),
        sty=torch.where(case1, stp, torch.where(opposite, stx, sty)),
        fy=torch.where(case1, fp, torch.where(opposite, fx, fy)),
        dy=torch.where(case1, dp, torch.where(opposite, dx, dy)),
        stp=stpf,
        brackt=brackt | case1 | case2,
    )


def _adjust_to_bounds(h, x, lower, upper, violated):
    """scipy ``_adjust_scheme_to_bounds`` ('1-sided', one step)."""
    lower_dist = x - lower
    upper_dist = upper - x
    fitting = h.abs() <= torch.maximum(lower_dist, upper_dist)
    h = torch.where(violated & fitting, -h, h)
    h = torch.where(~fitting & (upper_dist >= lower_dist), upper_dist, h)
    return torch.where(~fitting & (upper_dist < lower_dist), -lower_dist, h)


def _stable_fd_h(p, lower, upper, fd_step):
    """scipy's FD step at ``p`` for the symbolic-displacement evaluator:
    absolute ``fd_step`` used directly (the evaluator never forms
    ``p + h``), 1-sided bound adjustment on the exact distances."""
    h = torch.full_like(p, fd_step)
    return _adjust_to_bounds(h, p, lower, upper, (upper - p) < h)


class _SearchResult(NamedTuple):
    stp: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor  # full gradient at the accepted point
    failed: torch.Tensor


def _dcsrch_phi(phi, d, f0, g_vec0, stp0, stpmax, run, maxfev=20):
    """dcsrch over ``phi(stp) -> (f, gvec)`` for B lanes; lanes outside
    ``run`` start finished.

    Every decision compares f *differences*, so the search is
    translation invariant: the stable driver passes deltas with
    ``f0 = 0``.
    """
    dtype = f0.dtype
    g0 = _dot(g_vec0, d)
    gtest = _FTOL * g0
    zero = torch.zeros_like(f0)
    stpmin = zero

    st = _StepState(zero, f0, g0, zero, f0, g0, stp0, torch.zeros_like(run))
    stage1 = torch.ones_like(run)
    stmin = zero
    stmax = stp0 + _XTRAPU * stp0
    width = stpmax - stpmin
    width1 = (stpmax - stpmin) / 0.5
    nfev = torch.ones(f0.shape, dtype=torch.int32, device=f0.device)
    done = ~run
    conv = torch.zeros_like(run)
    f, gvec = phi(stp0)

    while True:
        live = ~done & (nfev < maxfev + 1)
        if not bool(live.any()):
            break
        stp = st.stp
        g = _dot(gvec, d)
        ftest = f0 + stp * gtest
        stage1_n = stage1 & ~((f <= ftest) & (g >= 0.0))
        converged = (f <= ftest) & (g.abs() <= _GTOL * (-g0))
        warn = (
            (st.brackt & ((stp <= stmin) | (stp >= stmax)))
            | (st.brackt & (stmax - stmin <= _XTOL * stmax))
            | ((stp == stpmax) & (f <= ftest) & (g <= gtest))
            | ((stp == stpmin) & ((f > ftest) | (g >= gtest)))
        )
        finished = converged | warn
        # modified-function stage-1 update
        use_mod = stage1_n & (f <= st.fx) & (f > ftest)
        st_mod = st._replace(
            fx=st.fx - st.stx * gtest,
            dx=st.dx - gtest,
            fy=st.fy - st.sty * gtest,
            dy=st.dy - gtest,
        )
        new_mod = _dcstep(st_mod, f - stp * gtest, g - gtest, stmin, stmax)
        new_mod = new_mod._replace(
            fx=new_mod.fx + new_mod.stx * gtest,
            fy=new_mod.fy + new_mod.sty * gtest,
            dx=new_mod.dx + gtest,
            dy=new_mod.dy + gtest,
        )
        new = _select_state(
            use_mod, new_mod, _dcstep(st, f, g, stmin, stmax)
        )

        # bisection safeguard
        span = (new.sty - new.stx).abs()
        bisect = new.brackt & (span >= 0.66 * width1)
        stp_n = torch.where(
            bisect, new.stx + 0.5 * (new.sty - new.stx), new.stp
        )
        width1_n = torch.where(new.brackt, width, width1)
        width_n = torch.where(new.brackt, span, width)
        stmin_n = torch.where(
            new.brackt,
            torch.minimum(new.stx, new.sty),
            stp_n + _XTRAPL * (stp_n - new.stx),
        )
        stmax_n = torch.where(
            new.brackt,
            torch.maximum(new.stx, new.sty),
            stp_n + _XTRAPU * (stp_n - new.stx),
        )
        stp_n = torch.minimum(torch.maximum(stp_n, stpmin), stpmax)
        force_stx = (
            new.brackt & ((stp_n <= stmin_n) | (stp_n >= stmax_n))
        ) | (new.brackt & (stmax_n - stmin_n <= _XTOL * stmax_n))
        stp_n = torch.where(force_stx, new.stx, stp_n)
        new = new._replace(stp=stp_n)

        # evaluate at the new trial point (consumed only if not finished)
        f_n, g_n = phi(stp_n)

        # a lane updates iff it is live and its search did not finish
        step = live & ~finished
        st = _select_state(step, new, st)
        stage1 = torch.where(step, stage1_n, stage1)
        stmin = torch.where(step, stmin_n, stmin)
        stmax = torch.where(step, stmax_n, stmax)
        width = torch.where(step, width_n, width)
        width1 = torch.where(step, width1_n, width1)
        nfev = torch.where(step, nfev + 1, nfev)
        f = torch.where(step, f_n, f)
        gvec = _sel(step, g_n, gvec)
        conv = conv | (live & converged)
        done = done | (live & finished)

    # dcsrch entry errors (initial derivative >= 0, stp0 outside the
    # bracket) are task='ERROR' in the Fortran -> mainlb's restart
    # machinery, same as running out of evaluations
    entry_error = (g0 >= 0.0) | (stp0 > stpmax) | (stp0 < stpmin)
    return _SearchResult(
        stp=st.stp, f=f, g=gvec, failed=~(done | conv) | entry_error
    )


def _solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a·x = b for d <= 3 in closed form (Cramer/adjugate); ``a``
    is the model Hessian on the free variables (positive definite,
    identity on fixed rows), so no pivoting is needed."""
    d = a.shape[-1]
    if d == 1:
        return b / a[..., 0, 0][..., None]
    if d == 2:
        det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        inv = torch.stack(
            [
                torch.stack([a[..., 1, 1], -a[..., 0, 1]], -1),
                torch.stack([-a[..., 1, 0], a[..., 0, 0]], -1),
            ],
            -2,
        ) / det[..., None, None]
        return _matvec(inv, b)
    if d == 3:
        def m(i, j):
            return a[..., i, j]

        c00 = m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1)
        c01 = m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2)
        c02 = m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)
        det = m(0, 0) * c00 + m(0, 1) * c01 + m(0, 2) * c02
        c10 = m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2)
        c11 = m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0)
        c12 = m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1)
        c20 = m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1)
        c21 = m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2)
        c22 = m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0)
        adj = torch.stack(
            [
                torch.stack([c00, c10, c20], -1),
                torch.stack([c01, c11, c21], -1),
                torch.stack([c02, c12, c22], -1),
            ],
            -2,
        )
        return _matvec(adj, b) / det[..., None]
    msg = f"_solve_small: d={d} > 3"
    raise ValueError(msg)


def _build_b(s_ord, y_ord, valid, theta, n_valid: int):
    """The limited-memory matrix B_k as an explicit (B, d, d) tensor:
    the stored BFGS updates applied to ``theta * I`` in chronological
    order (equal, in exact arithmetic, to the Byrd–Nocedal–Schnabel
    compact form the Fortran code factorises).  Slots at or beyond
    ``n_valid`` are invalid in every lane and are skipped."""
    d_dim = s_ord.shape[-1]
    eye = torch.eye(d_dim, dtype=s_ord.dtype, device=s_ord.device)
    b = theta[:, None, None] * eye
    for k in range(n_valid):
        s = s_ord[:, k]
        y = y_ord[:, k]
        bs = _matvec(b, s)
        sbs = _dot(s, bs)
        sy = _dot(s, y)
        bn = (
            b
            - _outer(bs, bs) / torch.where(sbs == 0.0, 1.0, sbs)[:, None, None]
            + _outer(y, y) / torch.where(sy == 0.0, 1.0, sy)[:, None, None]
        )
        b = _sel(valid[:, k], bn, b)
    return b


def _onehot(idx: torch.Tensor, d: int) -> torch.Tensor:
    return torch.arange(d, device=idx.device) == idx[:, None]


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return v.gather(-1, idx[:, None])[:, 0]


def _cauchy(x, g, lower, upper, bmat, theta, epsmch):
    """Generalized Cauchy point of the quadratic model (Fortran cauchy):
    walk the projected steepest-descent path breakpoint by breakpoint.
    Returns ``(xcp - x, free_mask)``."""
    d_dim = x.shape[-1]
    big = 1e30
    safe_g = torch.where(g == 0.0, 1.0, g)
    t_break = torch.where(
        g > 0.0,
        (x - lower) / safe_g,
        torch.where(g < 0.0, (x - upper) / safe_g, big),
    )
    moving = t_break > 0.0
    dvec = torch.where(moving, -g, 0.0)
    f2_org = theta * _dot(dvec, dvec)
    z = torch.zeros_like(x)
    xcp_z = torch.zeros_like(x)
    found = torch.zeros_like(theta, dtype=torch.bool)
    t_old = torch.zeros_like(theta)
    for _ in range(d_dim + 1):  # at most d breakpoints + the last segment
        bd = _matvec(bmat, dvec)
        f1 = _dot(g, dvec) + _dot(z, bd)
        f2 = torch.maximum(_dot(dvec, bd), epsmch * f2_org)
        dtm = -f1 / torch.where(f2 == 0.0, 1.0, f2)

        t_cand = torch.where(moving, t_break, big)
        b_idx = t_cand.argmin(-1)
        t_next = _take(t_cand, b_idx)
        dt = t_next - t_old
        inside = (dtm < dt) | (t_next >= big)
        xcp_candidate = z + torch.clamp_min(dtm, 0.0)[:, None] * dvec

        # advance to the breakpoint: variable b lands exactly on its bound
        hot = _onehot(b_idx, d_dim)
        zb = torch.where(
            _take(dvec, b_idx) > 0.0, _take(upper, b_idx), _take(lower, b_idx)
        ) - _take(x, b_idx)
        z_bp = torch.where(hot, zb[:, None], z + dt[:, None] * dvec)
        freeze = found | inside
        xcp_z = _sel(~found & inside, xcp_candidate, xcp_z)
        z = _sel(freeze, z, z_bp)
        dvec = _sel(freeze, dvec, torch.where(hot, 0.0, dvec))
        moving = _sel(freeze, moving, moving & ~hot)
        t_old = torch.where(freeze, t_old, t_next)
        found = found | inside
    return xcp_z, moving


def _subsm(x, g, bmat, xcp, free, lower, upper):
    """Subspace minimisation, lbfgsb 3.0 semantics: Newton step of the
    model over the free variables; project it if it leaves the box and
    keep the projection when it is a descent direction, else take the
    truncated-alpha step with the blocking variable snapped onto its
    bound."""
    d_dim = x.shape[-1]
    big = 1e30
    freef = free.to(x.dtype)
    r = g + _matvec(bmat, xcp - x)
    bmod = bmat * _outer(freef, freef) + torch.diag_embed(1.0 - freef)
    dsub = _solve_small(bmod, -(r * freef)) * freef

    zt = xcp + dsub
    iword = (free & ((zt < lower) | (zt > upper))).any(-1)
    zproj = torch.minimum(torch.maximum(zt, lower), upper)
    dd_p = _dot(zproj - x, g)

    safe_d = torch.where(dsub == 0.0, 1.0, dsub)
    low_gap = lower - xcp
    up_gap = upper - xcp
    cand = torch.where(
        free & (dsub < 0.0),
        torch.where(low_gap >= 0.0, 0.0, low_gap / safe_d),
        big,
    )
    cand = torch.where(
        free & (dsub > 0.0),
        torch.where(up_gap <= 0.0, 0.0, up_gap / safe_d),
        cand,
    )
    alpha = torch.clamp_max(cand.amin(-1), 1.0)
    ibd = cand.argmin(-1)
    z_alpha = xcp + alpha[:, None] * dsub
    bound_b = torch.where(
        _take(dsub, ibd) > 0.0, _take(upper, ibd), _take(lower, ibd)
    )
    snap = (alpha < 1.0)[:, None] & _onehot(ibd, d_dim)
    z_alpha = torch.where(snap, bound_b[:, None], z_alpha)

    z = _sel(iword & (dd_p > 0.0), z_alpha, zproj)
    return _sel(free.any(-1), z, xcp)


class LbfgsbResult(NamedTuple):
    x: torch.Tensor  # (B, d)
    fun: torch.Tensor  # (B,)
    nit: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,)
    #: stopped by the iteration budget, not by a scipy termination rule
    #: (a larger maxiter would continue); drives the fast-budget retry.
    capped: torch.Tensor  # (B,)


def _minimize(x, fx, g, lower, upper, line_search, stable, m, maxiter,
              pgtol, factr):
    """The mainlb iteration shared by both drivers.

    ``line_search(x, d, fx, g, stp0, stpmx, run)`` returns a
    :class:`_SearchResult` whose ``f`` is the new absolute f (classic)
    or the cancellation-free delta ``f(xn) - f(x)`` (stable).
    """
    bsz, d_dim = x.shape
    dtype, device = x.dtype, x.device
    tol = factr * _EPS64
    epsmch = torch.finfo(dtype).eps
    # bounds at |b| >= 1e9 are "infinite" sentinels; 'boxed' drives the
    # first-step rule of lnsrlb
    boxed = (lower.abs() < 1e9).all(-1) & (upper.abs() < 1e9).all(-1)

    s_hist = torch.zeros((bsz, m, d_dim), dtype=dtype, device=device)
    y_hist = torch.zeros_like(s_hist)
    theta = torch.ones(bsz, dtype=dtype, device=device)
    zero_i = torch.zeros(bsz, dtype=torch.int64, device=device)
    n_pairs, it, trips = zero_i, zero_i, zero_i
    done = torch.zeros(bsz, dtype=torch.bool, device=device)
    conv = done
    slots = torch.arange(m, device=device)

    def pg_max(x, g):
        return (x - torch.minimum(torch.maximum(x - g, lower), upper)).abs().amax(-1)

    while True:
        run = (
            ~done
            & (it < maxiter)
            & (trips < 2 * maxiter + 4)
            & (pg_max(x, g) > pgtol)
        )
        if not bool(run.any()):
            break
        col = torch.clamp_max(n_pairs, m)
        valid = slots < col[:, None]
        s_ord = _sel(valid, s_hist, torch.zeros_like(s_hist))
        y_ord = _sel(valid, y_hist, torch.zeros_like(y_hist))
        bmat = _build_b(s_ord, y_ord, valid, theta, int(col.max()))

        xcp_z, free = _cauchy(x, g, lower, upper, bmat, theta, epsmch)
        xcp = x + xcp_z
        z = _sel(col > 0, _subsm(x, g, bmat, xcp, free, lower, upper), xcp)
        d = z - x
        dnorm = torch.sqrt(_dot(d, d))
        gd_old = _dot(g, d)

        # lnsrlb step rules: the first iteration caps the search at
        # step 1; later ones take the distance to the box along d; the
        # first step is 1 unless the problem is not fully boxed
        big = 1e10
        safe_d = torch.where(d == 0, 1.0, d)
        step_to_bound = torch.where(
            d > 0,
            (upper - x) / safe_d,
            torch.where(d < 0, (lower - x) / safe_d, big),
        )
        first = it == 0
        stpmx = torch.where(
            first, 1.0, torch.clamp_max(step_to_bound.amin(-1), big)
        )
        inv_dnorm = 1.0 / torch.where(dnorm == 0, 1.0, dnorm)
        stp0 = torch.where(
            first & ~boxed, torch.minimum(inv_dnorm, stpmx), 1.0
        ).to(dtype)

        res = line_search(x, d, fx, g, stp0, stpmx.to(dtype), run)
        ls_failed = res.failed
        xn = x + res.stp[:, None] * d
        gn = res.g

        # mainlb convergence tests, in order: projected gradient at the
        # new point, then relative f reduction
        pg_done = pg_max(xn, gn) <= pgtol
        if stable:
            fn = fx + res.f
            reduction = -res.f
        else:
            fn = res.f
            reduction = fx - fn
        f_reduction_done = reduction <= tol * torch.clamp_min(
            torch.maximum(fx.abs(), fn.abs()), 1.0
        )
        step_ok = ~ls_failed
        new_conv = step_ok & (pg_done | f_reduction_done)
        if stable:
            # once the accepted step rounds to zero in the working dtype
            # the iterate cannot move again, while the symbolic deltas
            # keep reporting tiny "reductions" that never trip factr
            new_conv = new_conv | (step_ok & (xn == x).all(-1))

        # curvature pair update (mainlb dr/ddum + matupd)
        gd = _dot(gn, d)
        one_step = res.stp == 1.0
        dr = torch.where(one_step, gd - gd_old, (gd - gd_old) * res.stp)
        ddum = torch.where(one_step, -gd_old, -gd_old * res.stp)
        store = step_ok & (dr > _EPS64 * ddum)
        s = res.stp[:, None] * d
        y = gn - g
        # chronological append; shift left once the history is full
        full = n_pairs >= m
        at = (slots == torch.clamp_max(n_pairs, m - 1)[:, None])[..., None]
        s_app = torch.where(at, s[:, None, :], s_hist)
        y_app = torch.where(at, y[:, None, :], y_hist)
        s_shift = torch.cat([s_hist[:, 1:], s[:, None]], 1)
        y_shift = torch.cat([y_hist[:, 1:], y[:, None]], 1)
        s_hist_n = _sel(store, _sel(full, s_shift, s_app), s_hist)
        y_hist_n = _sel(store, _sel(full, y_shift, y_app), y_hist)
        n_pairs_n = torch.where(store, n_pairs + 1, n_pairs)
        theta_n = torch.where(
            store, _dot(y, y) / torch.where(dr == 0, 1.0, dr), theta
        )

        # restart machinery: a failed search with stored pairs wipes the
        # memory and retries from the same iterate without counting an
        # iteration; with no history it terminates
        restart = ls_failed & (col > 0)
        fatal = ls_failed & (col == 0)
        n_pairs_n = torch.where(restart, 0, n_pairs_n)
        theta_n = torch.where(restart, 1.0, theta_n)
        xn = _sel(ls_failed, x, xn)
        fn = torch.where(ls_failed, fx, fn)
        gn = _sel(ls_failed, g, gn)

        x = _sel(run, xn, x)
        fx = torch.where(run, fn, fx)
        g = _sel(run, gn, g)
        s_hist = _sel(run, s_hist_n, s_hist)
        y_hist = _sel(run, y_hist_n, y_hist)
        theta = torch.where(run, theta_n, theta)
        n_pairs = torch.where(run, n_pairs_n, n_pairs)
        it = torch.where(run & ~ls_failed, it + 1, it)
        trips = torch.where(run, trips + 1, trips)
        conv = conv | (run & new_conv)
        done = done | (run & (new_conv | fatal))

    pg_small = pg_max(x, g) <= pgtol
    return LbfgsbResult(
        x=x, fun=fx, nit=it, converged=conv | pg_small,
        capped=~done & ~pg_small,
    )


def lbfgsb_minimize_stable(
    probe: Callable,
    f_abs: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    m: int = _M,
    maxiter: int = 50,
    pgtol: float = 1e-5,
    factr: float = 1e7,
    maxls: int = 20,
    fd_step: float = _FD_ABS_STEP,
) -> LbfgsbResult:
    """Float32-native L-BFGS-B with float64-grade stopping behaviour.

    The algorithm consumes the objective only through differences, so
    every difference is taken symbolically by
    ``probe(x, disp, h) -> (f(x+disp) - f(x), FD gradient at x+disp)``
    (shapes (B, d) -> (B,), (B, d)), which never rounds ``x + disp``
    into the representation of ``x`` (see
    :func:`pywindow_torch.ops.geometry.clearance_diff`).  The driver runs
    in delta space; ``f_abs`` ((B, d) -> (B,)) only scales the ``factr``
    test and gives the reported ``fun``.  Every other rule is that of
    :func:`lbfgsb_minimize`.
    """
    x = torch.minimum(torch.maximum(x0, lower), upper)
    fx = f_abs(x)
    _, g = probe(x, torch.zeros_like(x), _stable_fd_h(x, lower, upper, fd_step))

    def line_search(x, d, fx, g, stp0, stpmx, run):
        def phi(stp):
            disp = stp[:, None] * d
            return probe(x, disp, _stable_fd_h(x + disp, lower, upper, fd_step))

        return _dcsrch_phi(
            phi, d, torch.zeros_like(fx), g, stp0, stpmx, run, maxfev=maxls
        )

    return _minimize(
        x, fx, g, lower, upper, line_search, True, m, maxiter, pgtol, factr
    )
