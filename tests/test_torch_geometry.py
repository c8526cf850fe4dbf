"""Encoding and geometry: pywindow_torch against pywindow_tpu in float64
on the same inputs (carried across with ``pywindow_torch.convert``).

Tolerance 1e-12: the same formulas, differing only in summation order
and fused multiply-adds (XLA contracts mul-add chains on the CPU; torch
rounds every op)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywindow_torch.ops import encoding as tenc
from pywindow_torch.ops import geometry as tg
from pywindow_tpu.ops import encoding as jenc
from pywindow_tpu.ops import geometry as jg
from tests.conftest import load_structure
from tests.test_torch_parity import both_encoded, random_mol, t

TOL = 1e-12


def _mols(case):
    if case == "random":
        return random_mol(61, seed=3, pad_to=72)
    return both_encoded(*load_structure(case))


def test_encode_matches_jax_field_for_field():
    elements, coords = load_structure("BATVUP")
    jm = jenc.encode(elements, coords, dtype=np.float64)
    tm = tenc.encode_batch([(elements, coords)], device="cpu")
    assert tm.coords.dtype == torch.float64
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
    # padded slots: parked far away, vdW 0, masked
    assert tm.coords.shape[1] % 8 == 0
    assert bool((tm.coords[~tm.mask] == tenc.FAR_AWAY).all())
    assert bool((tm.vdw[~tm.mask] == 0).all())


def test_encode_float32_and_pad_errors(monkeypatch):
    elements, coords = load_structure("YAQHOQ")
    monkeypatch.setenv("PYWINDOW_TORCH_FORCE_F32", "1")
    assert tenc.encode_batch([(elements, coords)], device="cpu").coords.dtype == torch.float32
    with pytest.raises(ValueError, match="pad_to"):
        tenc.encode_batch([(elements, coords)], pad_to=len(elements) - 1, device="cpu")


@pytest.mark.parametrize("case", ["PUDXES", "BATVUP", "random"])
def test_centres_weight_and_shift(case):
    jm, tm = _mols(case)
    for jf, tf in [
        (jg.center_of_mass, tg.center_of_mass),
        (jg.center_of_coor, tg.center_of_coor),
        (jg.molecular_weight, tg.molecular_weight),
    ]:
        np.testing.assert_allclose(tf(tm).numpy(), np.asarray(jf(jm)), atol=TOL, rtol=0)
    target = np.array([0.5, -1.0, 2.0])
    np.testing.assert_allclose(
        tg.shift_to(tm, t(target)).coords.numpy(),
        np.asarray(jg.shift_to(jm, jnp.asarray(target)).coords),
        atol=TOL, rtol=0,
    )


@pytest.mark.parametrize("case", ["PUDXES", "BATVUP", "random"])
def test_max_dim_and_pore(case):
    jm, tm = _mols(case)
    ja1, ja2, jd = jg.max_dim(jm)
    ta1, ta2, td = tg.max_dim(tm)
    assert (int(ta1), int(ta2)) == (int(ja1), int(ja2))
    assert float(td) == pytest.approx(float(jd), abs=TOL)
    assert float(tg.max_dim_value(tm)) == pytest.approx(
        float(jg.max_dim_value(jm)), abs=TOL
    )
    jpd, jat = jg.pore_diameter(jm)
    tpd, tat = tg.pore_diameter(tm)
    assert float(tpd) == pytest.approx(float(jpd), abs=TOL)
    # the limiting atom: the same one, or (on a symmetric cage, where
    # several atoms tie to the last bit) one that attains the minimum
    com = tg.center_of_mass(tm)
    gap = tg.pairwise_distances(com[None], tm.coords)[0] - tm.vdw
    assert 2 * float(gap[int(tat)]) == pytest.approx(float(jpd), abs=TOL)
    assert 2 * float(gap[int(jat)]) == pytest.approx(float(tpd), abs=TOL)
    assert float(tg.sphere_volume(tpd / 2)) == pytest.approx(
        float(jg.sphere_volume(jpd / 2)), rel=TOL
    )


@pytest.mark.parametrize("case", ["PUDXES", "random"])
def test_clearance_field_diff_and_probe(case):
    jm, tm = _mols(case)
    rng = np.random.default_rng(11)
    centre = np.asarray(jg.center_of_mass(jm))
    probes = centre + rng.normal(size=(40, 3))
    c_j, i_j = jg.clearance_and_argmin(jnp.asarray(probes), jm)
    c_t, i_t = tg.clearance_and_argmin(t(probes), tm)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(
        tg.clearance_field(t(probes), tm).numpy(),
        np.asarray(jg.clearance_field(jnp.asarray(probes), jm)),
        atol=TOL, rtol=0,
    )
    # symbolic differences, from macroscopic down to FD-sized steps
    x = probes[0]
    disp = rng.normal(size=(12, 3)) * np.logspace(-9, -1, 12)[:, None]
    np.testing.assert_allclose(
        tg.clearance_diff(t(x), t(disp), tm).numpy(),
        np.asarray(jg.clearance_diff(jnp.asarray(x), jnp.asarray(disp), jm)),
        atol=TOL, rtol=0,
    )
    h = np.full(3, 1e-8)
    d_j, g_j = jg.pore_stable_probe(jm)(
        jnp.asarray(x), jnp.asarray(disp[-1]), jnp.asarray(h)
    )
    # the port's pore probe (lbfgsb_kernels' plain version) from the same
    # symbolic differences
    d_t = -2.0 * tg.clearance_diff(t(x), t(disp[-1])[None], tm)[0]
    g_t = -2.0 * tg.clearance_diff(t(x + disp[-1]), torch.diag(t(h)), tm) / t(h)
    assert float(d_t) == pytest.approx(float(d_j), abs=TOL)
    # FD quotients of symbolic differences (no 1/h amplification of an
    # absolute-f rounding error)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-9, rtol=0)
