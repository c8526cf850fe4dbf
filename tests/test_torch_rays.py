"""Ray sampling and the ray kernels' plain versions against pywindow_tpu
in float64: the Pallas kernels run in interpret mode (as
tests/test_pallas.py runs them) and the jnp paths.

Flags and argmin steps must be identical; values agree to 1e-10 (the
Pallas path sweep uses the Gram form, ~1e-13 off the difference form in
float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywindow_torch.ops import _cuda, ray_kernels
from pywindow_torch.ops import rays as trays
from pywindow_tpu.ops import pallas_kernels, rays as jrays
from tests.test_torch_parity import random_mol, t

TOL = 1e-10


def test_spiral_point_counts_and_eps():
    for r in (3.1, 11.09, 24.0):
        assert trays.number_of_points(r) == jrays.number_of_points(r)
    n = trays.number_of_points(11.09)
    radius = 11.09
    np.testing.assert_allclose(
        trays.golden_spiral(n, torch.tensor(radius, dtype=torch.float64)).numpy(),
        np.asarray(jrays.golden_spiral(n, radius, dtype=jnp.float64)),
        atol=1e-12, rtol=0,
    )
    assert float(
        trays.mean_knn_eps_scaled(n, torch.tensor(radius, dtype=torch.float64))
    ) == pytest.approx(
        float(jrays.mean_knn_eps_scaled(n, jnp.asarray(radius))), abs=1e-12
    )


def _frame(jm, tm, n_points, radius):
    pts = np.asarray(jrays.golden_spiral(n_points, radius, dtype=jnp.float64))
    unit, rel, origin = trays._ray_frame(t(pts), tm)
    return pts, unit, rel, origin


@pytest.mark.parametrize("want_exit", [True, False])
def test_ray_exit_plain_matches_pallas_and_jnp(want_exit):
    jm, tm = random_mol(120, seed=7, pad_to=128)
    pts, unit, rel, origin = _frame(jm, tm, 256, 14.0)
    anyf, mexit = ray_kernels.ray_exit_plain(unit, rel, tm.vdw, origin, want_exit)

    p_any, p_exit = pallas_kernels.ray_exit_pallas(
        jnp.asarray(unit.numpy()), jnp.asarray(rel.numpy()),
        jnp.asarray(tm.vdw.numpy()), jnp.asarray(origin.numpy()),
        interpret=True, want_exit=want_exit,
    )
    np.testing.assert_array_equal(anyf.numpy(), np.asarray(p_any) > 0.5)
    if want_exit:
        has_j, d_j = jrays.reversed_exit_distance(pts, jm, use_pallas=False)
        np.testing.assert_array_equal(anyf.numpy(), np.asarray(has_j))
        hit = anyf.numpy()
        assert hit.any() and not hit.all()
        np.testing.assert_allclose(mexit.numpy()[hit], np.asarray(p_exit)[hit], atol=TOL, rtol=0)
        np.testing.assert_allclose(mexit.numpy(), np.asarray(d_j), atol=TOL, rtol=0)
    else:
        open_j = jrays.preanalysis_open(pts, jm, use_pallas=False)
        np.testing.assert_array_equal(~anyf.numpy(), np.asarray(open_j))
        assert bool((mexit == -1e30).all())


@pytest.mark.parametrize(("p", "n", "steps"), [(64, 40, 12), (200, 168, 16)])
def test_path_sweep_plain_matches_pallas_and_jnp(p, n, steps):
    jm, tm = random_mol(n, seed=p + n, pad_to=((n + 63) // 64) * 64)
    pts = np.asarray(jrays.golden_spiral(p, 9.5, dtype=jnp.float64))
    norm, chunks = trays._chunks(t(pts), 1.0)
    ok, pos, cmin = ray_kernels.path_sweep_plain(
        t(pts), chunks, tm.coords, tm.vdw, steps
    )
    okp, posp, cminp = pallas_kernels.path_sweep_pallas(
        jnp.asarray(pts), jnp.asarray(chunks.numpy()), jm.coords, jm.vdw,
        steps, interpret=True,
    )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okp) > 0.5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(posp).astype(np.int32))
    np.testing.assert_allclose(cmin.numpy(), np.asarray(cminp), atol=TOL, rtol=0)

    ref = jrays.path_analysis(pts, jm, 1.0, steps, use_pallas=False)
    got = trays.path_analysis(t(pts), tm, 1.0, steps)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    for key in ("dist", "width", "narrow"):
        np.testing.assert_allclose(
            getattr(got, key).numpy(), np.asarray(getattr(ref, key)),
            atol=TOL, rtol=0,
        )


def test_fine_path_matches_chunked_scan():
    """The W-slot fine sweep: the step-chunked scan of the JAX package
    (identical arithmetic to the dense form)."""
    jm, tm = random_mol(90, seed=5, pad_to=96)
    # radius 8.37: |v| / 0.1 far from an integer, so both packages
    # agree on the chunk counts
    vec = np.asarray(jrays.golden_spiral(8, 8.37, dtype=jnp.float64))
    steps = 88
    ok_j, pos_j, w_j = jrays._path_small_p_chunked(
        jnp.asarray(vec),
        jnp.maximum(jnp.floor(jnp.linalg.norm(vec, axis=-1) / 0.1).astype(jnp.int32), 1),
        jm, steps,
    )
    got = trays.fine_path_analysis(t(vec), tm, 0.1, steps)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(got.width.numpy(), np.asarray(w_j), atol=TOL, rtol=0)
    norm, chunks = trays._chunks(t(vec), 0.1)
    np.testing.assert_allclose(
        got.dist.numpy(),
        (norm * t(np.asarray(pos_j)) / chunks.double()).numpy(),
        atol=TOL, rtol=0,
    )
    # and the dense form of the same sweep agrees exactly on ok and pos
    dense = trays.path_analysis(t(vec), tm, 0.1, steps)
    np.testing.assert_array_equal(dense.ok.numpy(), got.ok.numpy())
    np.testing.assert_array_equal(dense.dist.numpy(), got.dist.numpy())


def test_average_diameter_matches_jax():
    jm, tm = random_mol(100, seed=2, pad_to=104)
    n = 300
    got = trays.average_diameter(tm, n, torch.tensor(18.0, dtype=torch.float64))
    ref = jrays.average_diameter(jm, n, 18.0)
    assert float(got) == pytest.approx(float(ref), abs=TOL)


def test_wrappers_route_by_device_and_never_fall_back():
    jm, tm = random_mol(30, seed=1, pad_to=32)
    pts = trays.golden_spiral(50, torch.tensor(9.0, dtype=torch.float64))
    unit, rel, origin = trays._ray_frame(pts, tm)
    order = trays.spiral_tile_order(50, torch.device("cpu"))
    before = dict(_cuda.LAUNCHES)
    a = ray_kernels.ray_exit(unit, rel, tm.vdw, origin, True, order)
    b = ray_kernels.ray_exit_plain(unit, rel, tm.vdw, origin)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert dict(_cuda.LAUNCHES) == before  # the plain path launches nothing
    with pytest.raises(ValueError, match="device"):
        ray_kernels.ray_exit(unit.to("meta"), rel, tm.vdw, origin, True, order)
    # the kernel wrappers refuse CPU tensors instead of running elsewhere
    with pytest.raises(ValueError, match="CUDA"):
        ray_kernels.ray_exit_cuda(unit, rel, tm.vdw, origin, True, order)
    _, chunks = trays._chunks(pts, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        ray_kernels.path_sweep_cuda(pts, chunks, tm.coords, tm.vdw, 16)
