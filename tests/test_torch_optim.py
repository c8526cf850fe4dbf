"""The port's optimisers against pywindow_tpu's and scipy's, on the
cases of tests/test_optim.py and on the CC3 pore objective.

A forward-difference gradient with scipy's h = 1e-8 amplifies a
last-bit difference in f by 1/h.  XLA contracts mul-add chains into
fused multiply-adds on the CPU and evaluates sin/cos with its own
approximations, torch rounds every op, so the two packages' float64
drivers stop at the same point to 1e-9 on polynomial objectives, to
1e-7 where the objective has transcendental terms (measured up to
4e-8), and to 1e-6 on the clearance objective (scipy itself is held to
1e-6 there by tests/test_optim.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import fmin, minimize

from pywindow_torch.ops import geometry as tg
from pywindow_torch.ops.lbfgsb import lbfgsb_minimize, lbfgsb_minimize_stable
from pywindow_torch.ops.lbfgsb_kernels import lbfgsb_stable_flat_plain
from pywindow_torch.ops.optim import brute_then_polish, nelder_mead
from pywindow_tpu import tables
from pywindow_tpu.ops import geometry as jg
from pywindow_tpu.ops import lbfgsb as jl
from pywindow_tpu.ops import optim as jo
from tests.conftest import load_structure
from tests.test_torch_parity import both_encoded, t

_A = np.array([[4.0, 1.0, 0.2], [1.0, 3.0, 0.5], [0.2, 0.5, 2.0]])
_B = np.array([10.0, -4.0, 3.0])


def _const(v, X, lib):
    if lib is torch:
        return torch.as_tensor(v, dtype=X.dtype)
    return lib.asarray(v)


def _quad(X, lib):
    A, b = _const(_A, X, lib), _const(_B, X, lib)
    return 0.5 * ((X @ A) * X).sum(-1) - X @ b


def _ros(X, lib):
    return (1 - X[..., 0]) ** 2 + 100.0 * (X[..., 1] - X[..., 0] ** 2) ** 2


def _trig(X, lib):
    return (
        lib.sin(3 * X[..., 0]) * lib.cos(2 * X[..., 1])
        + 0.1 * X[..., 0] ** 2
        + 0.05 * X[..., 1] ** 2
        + 0.3 * X[..., 0] * X[..., 1]
    )


def _q1d(X, lib):
    return (X[..., 0] - 2.0) ** 2


#: (label, f, x0, lower, upper, stop-point tolerance against JAX)
CASES = [
    ("face", _quad, [0.0, 0.0, 0.0], [-1.0] * 3, [1.0] * 3, 1e-9),
    ("corner", _quad, [0.0, 0.0, 0.0], [-0.5] * 3, [0.2] * 3, 1e-9),
    ("start-on-bound", _quad, [1.0, -1.0, 1.0], [-1.0] * 3, [1.0] * 3, 1e-9),
    ("rosenbrock", _ros, [-1.2, 1.0], [-2.0, -2.0], [0.5, 2.0], 1e-9),
    ("trig", _trig, [0.3, 0.3], [-0.4, -0.4], [0.4, 0.4], 1e-7),
    ("1d-upper", _q1d, [0.0], [-0.5], [1.0], 1e-9),
]
IDS = [c[0] for c in CASES]


def _np(f):
    return lambda x: float(f(np.asarray(x)[None], np)[0])


@pytest.mark.parametrize(("label", "f", "x0", "lo", "hi", "tol"), CASES, ids=IDS)
def test_lbfgsb_matches_jax_and_scipy(label, f, x0, lo, hi, tol):
    x0, lo, hi = (np.asarray(v, np.float64) for v in (x0, lo, hi))
    got = lbfgsb_minimize(
        lambda X: f(X, torch), t(x0)[None], t(lo)[None], t(hi)[None], maxiter=200
    )
    ref_j = jax.jit(
        lambda c, a, b: jl.lbfgsb_minimize(lambda X: f(X, jnp), c, a, b, maxiter=200)
    )(jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi))
    ref = minimize(_np(f), x0=x0, bounds=list(zip(lo, hi)))
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref_j.x), atol=tol, rtol=0)
    assert int(got.nit[0]) == int(ref_j.nit)
    np.testing.assert_allclose(got.x[0].numpy(), ref.x, atol=1e-7, rtol=0)
    assert float(got.fun[0]) == pytest.approx(ref.fun, abs=1e-9)
    assert not bool(got.capped[0])


def _exact_probe(f):
    """Symbolic-difference probe computed in float64, handed back in the
    caller's dtype (as tests/test_optim.py::_exact_probe)."""

    def probe(x, disp, h):
        x64, p64, h64 = x.double(), (x.double() + disp.double()), h.double()
        fp = f(p64[:, None, :], torch)[:, 0]
        delta = fp - f(x64[:, None, :], torch)[:, 0]
        probes = f(p64[:, None, :] + torch.diag_embed(h64), torch) - fp[:, None]
        return delta.to(x.dtype), (probes / h64).to(x.dtype)

    return probe


def _exact_probe_jax(f):
    def probe(x, disp, h):
        x64, p64, h64 = x.astype(jnp.float64), x.astype(jnp.float64) + disp, h.astype(jnp.float64)
        fp = f(p64[None, :], jnp)[0]
        delta = fp - f(x64[None, :], jnp)[0]
        probes = f(p64[None, :] + jnp.diag(h64), jnp) - fp
        return delta.astype(x.dtype), (probes / h64).astype(x.dtype)

    return probe


@pytest.mark.parametrize(("label", "f", "x0", "lo", "hi", "tol"), CASES, ids=IDS)
def test_lbfgsb_stable_float32_matches_jax_and_scipy(label, f, x0, lo, hi, tol):
    x0, lo, hi = (np.asarray(v, np.float32) for v in (x0, lo, hi))
    got = lbfgsb_minimize_stable(
        _exact_probe(f),
        lambda x: f(x.double()[:, None, :], torch)[:, 0].to(x.dtype),
        t(x0)[None], t(lo)[None], t(hi)[None], maxiter=200,
    )
    assert got.x.dtype == torch.float32
    ref_j = jax.jit(
        lambda c, a, b: jl.lbfgsb_minimize_stable(
            _exact_probe_jax(f),
            lambda x: f(x[None, :].astype(jnp.float64), jnp)[0].astype(x.dtype),
            c, a, b, maxiter=200,
        )
    )(jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref_j.x), atol=1e-6, rtol=0)
    ref = minimize(
        _np(f), x0=x0.astype(np.float64),
        bounds=list(zip(lo.astype(np.float64), hi.astype(np.float64))),
    )
    np.testing.assert_allclose(got.x[0].numpy().astype(np.float64), ref.x, atol=5e-5)


@pytest.mark.parametrize("seed", range(4))
def test_lbfgsb_random_fuzz_matches_jax(seed):
    """Random PSD quadratics plus a trig bump in random (sometimes
    pinning) boxes, as tests/test_optim.py::test_lbfgsb_random_fuzz_vs_scipy."""
    rng = np.random.default_rng(seed)
    d = int(rng.integers(1, 4))
    a = rng.normal(size=(d, d))
    A = a @ a.T + np.eye(d) * 0.3
    b = rng.normal(size=d) * 3.0
    w = rng.normal(size=d)
    amp = float(rng.uniform(0.0, 0.3))

    def f(X, lib):
        As, bs, ws = (_const(v, X, lib) for v in (A, b, w))
        return 0.5 * ((X @ As) * X).sum(-1) - X @ bs + amp * lib.sin(X @ ws)

    centre = rng.normal(size=d) * 2.0
    half = rng.uniform(0.3, 2.0, size=d)
    lo, hi = centre - half, centre + half
    x0 = np.clip(rng.normal(size=d) * 2.0, lo, hi)
    got = lbfgsb_minimize(
        lambda X: f(X, torch), t(x0)[None], t(lo)[None], t(hi)[None], maxiter=200
    )
    ref_j = jax.jit(
        lambda c, a_, b_: jl.lbfgsb_minimize(lambda X: f(X, jnp), c, a_, b_, maxiter=200)
    )(jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref_j.x), atol=1e-7, rtol=0)
    ref = minimize(_np(f), x0=x0, bounds=list(zip(lo, hi)))
    np.testing.assert_allclose(got.x[0].numpy(), ref.x, atol=2e-6)


@pytest.mark.parametrize("name", ["PUDXES", "BATVUP"])
def test_lbfgsb_cc3_pore_objective(name):
    """The pore objective -2*clearance in an offset box that pins the
    optimum on 1-3 faces (tests/test_optim.py::test_lbfgsb_bound_pinned_cage),
    classic float64 driver, and the stable driver on the same box."""
    elements, coords = load_structure(name)
    jm, tm = both_encoded(elements, coords)
    com = np.asarray(jg.center_of_mass(jm))
    r = float(jg.pore_diameter(jm)[0]) / 2.0
    lo, hi = com + 0.15 * r, com + 0.60 * r
    x0 = lo + 0.7 * (hi - lo)

    got = lbfgsb_minimize(
        lambda p: -2.0 * tg.clearance_field(p, tm), t(x0)[None], t(lo)[None], t(hi)[None]
    )
    ref_j = jax.jit(
        lambda c, a, b: jl.lbfgsb_minimize(
            lambda p: -2.0 * jg.clearance_field(p, jm), c, a, b
        )
    )(jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref_j.x), atol=1e-6, rtol=0)

    vdw = tables.ELEMENT_VDW[tables.element_ids(elements)]
    ref = minimize(
        lambda p: -2 * np.min(np.linalg.norm(coords - p, axis=1) - vdw),
        x0=x0, bounds=list(zip(lo, hi)),
    )
    np.testing.assert_allclose(got.x[0].numpy(), ref.x, atol=1e-6)

    # the stable driver through the pore stage's plain kernel version
    stable_x, *_ = lbfgsb_stable_flat_plain(
        tm.coords[None], tm.vdw[None], torch.zeros(1, 3, dtype=torch.float64),
        t(x0)[None], t(lo)[None], t(hi)[None],
    )
    np.testing.assert_allclose(stable_x[0].numpy(), ref.x, atol=1e-6)


def test_lanes_stop_independently():
    """B lanes in one call == each lane alone, bitwise (vmap-of-while),
    for both drivers and Nelder-Mead."""
    x0 = np.array([[-1.2, 1.0], [0.3, 0.3], [0.0, 0.5]])
    lo = np.full((3, 2), -2.0)
    hi = np.array([[0.5, 2.0], [0.4, 0.4], [2.0, 2.0]])

    def f(X):
        return _ros(X, torch) * (X[..., :1].sum(-1) * 0 + 1) + _trig(X, torch)

    both = lbfgsb_minimize(f, t(x0), t(lo), t(hi), maxiter=200)
    for i in range(3):
        one = lbfgsb_minimize(f, t(x0[i : i + 1]), t(lo[i : i + 1]), t(hi[i : i + 1]), maxiter=200)
        assert torch.equal(one.x[0], both.x[i])
        assert int(one.nit[0]) == int(both.nit[i])

    x32 = t(x0, np.float32)
    fa = lambda x: f(x.double()[:, None, :])[:, 0].to(x.dtype)  # noqa: E731

    def probe(x, disp, h):
        return _exact_probe(lambda X, lib: f(X))(x, disp, h)

    both_s = lbfgsb_minimize_stable(probe, fa, x32, t(lo, np.float32), t(hi, np.float32))
    for i in range(3):
        one = lbfgsb_minimize_stable(
            probe, fa, x32[i : i + 1], t(lo[i : i + 1], np.float32), t(hi[i : i + 1], np.float32)
        )
        assert torch.equal(one.x[0], both_s.x[i])

    nm_both = nelder_mead(f, t(x0), maxiter=150)
    for i in range(3):
        one = nelder_mead(f, t(x0[i : i + 1]), maxiter=150)
        assert torch.equal(one[0][0], nm_both[0][i])
        assert bool(one[2][0]) == bool(nm_both[2][i])


def _bowl(x, lib):
    return (x[..., 0] - 1.3) ** 2 + 3.0 * (x[..., 1] + 0.7) ** 2 + lib.sin(
        x[..., 0] * x[..., 1]
    ) * 0.1


def test_nelder_mead_matches_jax_and_fmin():
    x_t, f_t, capped = nelder_mead(lambda X: _bowl(X, torch), t(np.zeros((1, 2))), maxiter=400)
    x_j, f_j, _ = jo.nelder_mead(lambda x: _bowl(x, jnp), jnp.zeros(2), maxiter=400)
    np.testing.assert_allclose(x_t[0].numpy(), np.asarray(x_j), atol=1e-9, rtol=0)
    x_sp = fmin(_np(_bowl), np.zeros(2), disp=False, xtol=1e-8, ftol=1e-12)
    np.testing.assert_allclose(x_t[0].numpy(), x_sp, atol=1e-5)
    assert not bool(capped[0])
    # bounds clip every vertex into the box
    xb, _, _ = nelder_mead(
        lambda X: ((X - 5.0) ** 2).sum(-1), t(np.zeros((1, 2))),
        lower=t([[-1.0, -1.0]]), upper=t([[1.0, 1.0]]), maxiter=300,
    )
    assert bool((xb <= 1.0 + 1e-12).all())


def test_brute_then_polish_matches_jax():
    def f(x, lib):
        return (
            lib.cos(3 * x[..., 0]) * lib.cos(2 * x[..., 1])
            + 0.1 * (x[..., 0] + 1.5) ** 2
            + 0.1 * (x[..., 1] - 0.5) ** 2
        )

    x_t, f_t, _ = brute_then_polish(
        lambda X: f(X, torch), t([[-2.0, -2.0]]), t([[2.0, 2.0]]), ns=20
    )
    x_j, f_j, _ = jo.brute_then_polish(
        lambda x: f(x, jnp), jnp.array([-2.0, -2.0]), jnp.array([2.0, 2.0]), ns=20
    )
    np.testing.assert_allclose(x_t[0].numpy(), np.asarray(x_j), atol=1e-9, rtol=0)
    assert float(f_t[0]) == pytest.approx(float(f_j), abs=1e-12)
