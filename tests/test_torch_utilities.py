"""``pywindow_torch.utilities`` against ``pywindow_tpu.utilities`` on
PUDXES (CC3, 168 atoms, four windows) and YAQHOQ (60 atoms, no window),
on the CPU in float64.

Tolerances: host numpy helpers 1e-10 (the same float64 formulas);
device functions 1e-8 Å where no optimiser runs and 1e-4 Å for
optimised diameters, centres and windows (XLA's fused multiply-adds,
amplified by the FD gradients; see tests/test_torch_analysis.py).  The
limiting atom of a pore is compared through its clearance, since a
symmetric cage has several atoms at the same distance.
"""

import numpy as np
import pytest
import torch

import pywindow_torch as pt
from pywindow_torch import tables
from pywindow_torch import utilities as tu
from pywindow_tpu import utilities as ju
from tests.conftest import DATA, load_xyz

EXACT = 1e-8
OPTIMISED = 1e-4
HOST = 1e-10
SYSTEMS = ["PUDXES", "YAQHOQ"]


@pytest.fixture(scope="module", params=SYSTEMS)
def system(request):
    return load_xyz(DATA / f"{request.param}.xyz")


def _clearance(elements, coords, centre, atom):
    vdw = tables.ELEMENT_VDW[tables.element_ids(elements)]
    return float(np.linalg.norm(np.asarray(coords)[atom] - centre) - vdw[atom])


def test_surfaces_match():
    public = {n for n in dir(ju) if not n.startswith("_") and callable(getattr(ju, n))}
    assert public <= set(dir(tu))
    assert pt.compare_properties_dict is tu.compare_properties_dict
    assert pt.Output.__module__ == "pywindow_torch.io.outputs"


def test_host_helpers(system):
    el, co = system
    for name in ("center_of_coor",):
        np.testing.assert_allclose(getattr(tu, name)(co), getattr(ju, name)(co), atol=HOST, rtol=0)
    for name in ("center_of_mass", "shift_com", "get_gyration_tensor", "get_inertia_tensor"):
        np.testing.assert_allclose(
            getattr(tu, name)(el, co), np.asarray(getattr(ju, name)(el, co)), atol=HOST, rtol=0
        )
    for name in ("calc_asphericity", "calc_acylidricity", "calc_relative_shape_anisotropy"):
        assert getattr(tu, name)(el, co) == pytest.approx(getattr(ju, name)(el, co), abs=HOST)
    assert tu.molecular_weight(el) == ju.molecular_weight(el)
    # a symmetric cage's near-degenerate axes are ill-defined: rotations
    # only, here (to 1e-3: the reference rounds each axis to 4 decimals
    # before building its matrix, utilities.py:539-555); against the JAX
    # package on an asymmetric molecule below
    rot_t, mats_t = tu.align_principal_ax(el, co)
    for m in mats_t:
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-3, rtol=0)
    np.testing.assert_allclose(
        np.linalg.norm(rot_t - rot_t[0], axis=1), np.linalg.norm(co - co[0], axis=1),
        atol=0, rtol=1e-3,
    )
    assert tu.compose_atom_list(el, co) == ju.compose_atom_list(el, co)
    d_t = tu.decompose_atom_list(tu.compose_atom_list(el, co))
    np.testing.assert_array_equal(d_t[1], ju.decompose_atom_list(ju.compose_atom_list(el, co))[1])
    assert tu.circumcircle(co, [[0, 1, 2], [3, 4, 5]])[0] == pytest.approx(
        ju.circumcircle(co, [[0, 1, 2], [3, 4, 5]])[0], abs=HOST
    )


def test_align_principal_ax_on_an_asymmetric_molecule():
    """Twelve atoms from a seed (distinct inertia eigenvalues): the
    aligned coordinates and rotations equal the JAX package's."""
    rng = np.random.default_rng(3)
    el = np.array(["C", "N", "O", "H"] * 3)
    co = rng.normal(size=(12, 3)) * np.array([3.0, 2.0, 1.0])
    rot_t, mats_t = tu.align_principal_ax(el, co)
    rot_j, mats_j = ju.align_principal_ax(el, co)
    np.testing.assert_allclose(rot_t, rot_j, atol=1e-8, rtol=0)
    for a, b in zip(mats_t, mats_j):
        np.testing.assert_allclose(a, b, atol=1e-8, rtol=0)
    np.testing.assert_allclose(
        tu.principal_axes(el, co), ju.principal_axes(el, co), atol=1e-8, rtol=0
    )


def test_small_helpers():
    assert tu.distance([0, 0, 0], [3, 4, 0]) == ju.distance([0, 0, 0], [3, 4, 0]) == 5.0
    assert tu.unique([3, 1, 3, 2, 1]) == [3, 1, 2]
    assert tu.angle_between_vectors([1, 0, 0], [0, 1, 1]) == ju.angle_between_vectors(
        [1, 0, 0], [0, 1, 1]
    )
    np.testing.assert_array_equal(
        tu.normal_vector([0, 0, 0], [[1, 0, 0], [0, 1, 0]]),
        ju.normal_vector([0, 0, 0], [[1, 0, 0], [0, 1, 0]]),
    )
    np.testing.assert_array_equal(
        tu.rotation_matrix_arbitrary_axis(0.7, [1, 2, 3]),
        ju.rotation_matrix_arbitrary_axis(0.7, [1, 2, 3]),
    )
    assert tu.is_number("1e3") and not tu.is_number("x")
    assert tu.sphere_volume(2.0) == ju.sphere_volume(2.0)
    a = {"pore_diameter": {"diameter": 5.0, "atom": 3}, "windows": {"diameters": None}}
    b = {"pore_diameter": {"diameter": 5.0 + 1e-3, "atom": 3}, "windows": {"diameters": None}}
    for kw in ({}, {"atol": 0.01}):
        assert tu.compare_properties_dict(a, b, **kw) == ju.compare_properties_dict(a, b, **kw)


def test_max_dim_and_pore_diameter(system):
    el, co = system
    a1, a2, d = tu.max_dim(el, co, device="cpu")
    assert (a1, a2) == ju.max_dim(el, co)[:2]
    assert d == pytest.approx(ju.max_dim(el, co)[2], abs=EXACT)
    for com in (None, np.asarray(ju.center_of_mass(el, co)) + 0.3):
        d, atom = tu.pore_diameter(el, co, com=com, device="cpu")
        jd, jatom = ju.pore_diameter(el, co, com=com)
        assert d == pytest.approx(jd, abs=EXACT)
        centre = tu.center_of_mass(el, co) if com is None else com
        assert _clearance(el, co, centre, atom) == pytest.approx(jd / 2, abs=EXACT)


def test_opt_pore_diameter(system):
    el, co = system
    d, atom, centre = tu.opt_pore_diameter(el, co, device="cpu")
    jd, _, jcentre = ju.opt_pore_diameter(el, co)
    assert d == pytest.approx(jd, abs=OPTIMISED)
    np.testing.assert_allclose(centre, np.asarray(jcentre), atol=OPTIMISED, rtol=0)
    assert _clearance(el, co, centre, atom) == pytest.approx(d / 2, abs=EXACT)
    com = np.asarray(ju.center_of_mass(el, co))
    bounds = np.stack([com - 0.5, com + 0.5], axis=1)
    d, _, centre = tu.opt_pore_diameter(el, co, bounds=bounds, device="cpu")
    jd, _, jcentre = ju.opt_pore_diameter(el, co, bounds=bounds)
    assert d == pytest.approx(jd, abs=OPTIMISED)
    np.testing.assert_allclose(centre, np.asarray(jcentre), atol=OPTIMISED, rtol=0)


def test_find_average_diameter(system):
    el, co = system
    assert tu.find_average_diameter(el, co, device="cpu") == pytest.approx(
        ju.find_average_diameter(el, co), abs=EXACT
    )


def test_find_windows(system):
    el, co = system
    got, ref = tu.find_windows(el, co, device="cpu"), ju.find_windows(el, co)
    assert (got is None) == (ref is None)
    if ref is not None:
        order, jorder = np.argsort(got[0]), np.argsort(ref[0])
        np.testing.assert_allclose(got[0][order], ref[0][jorder], atol=OPTIMISED, rtol=0)
        np.testing.assert_allclose(got[1][order], ref[1][jorder], atol=OPTIMISED, rtol=0)


@pytest.mark.parametrize("scale", [1.0, 1.08])
def test_window_analysis(scale):
    """One window cluster of PUDXES (five open rays of the pore-centred
    cage), with the table radii and with radii inflated by 8% (which only
    the re-sampling sees)."""
    el, co = load_xyz(DATA / "PUDXES.xyz")
    co = co - np.asarray(ju.center_of_mass(el, co))
    vdw = tables.ELEMENT_VDW[tables.element_ids(el)] * scale
    rng = np.random.default_rng(1)
    rows = []
    while len(rows) < 5:
        v = rng.normal(size=3)
        res = ju.vector_preanalysis(v / np.linalg.norm(v) * 10.0, co, vdw)
        if res is not None:
            rows.append(res)
    window = np.array(rows)
    got = tu.window_analysis(window, el, co, vdw, device="cpu")
    ref = ju.window_analysis(window, el, co, vdw)
    assert (got is None) == (ref is None)
    if ref is not None:
        assert got[0] == pytest.approx(ref[0], abs=OPTIMISED)
        np.testing.assert_allclose(got[1], np.asarray(ref[1]), atol=OPTIMISED, rtol=0)


def test_vector_functions(system):
    el, co = system
    co = co - np.asarray(ju.center_of_mass(el, co))
    vdw = tables.ELEMENT_VDW[tables.element_ids(el)]
    rng = np.random.default_rng(5)
    for _ in range(10):
        v = rng.normal(size=3)
        v = v / np.linalg.norm(v) * rng.uniform(4.0, 11.0)
        for name in ("vector_analysis", "vector_preanalysis"):
            got, ref = getattr(tu, name)(v, co, vdw), getattr(ju, name)(v, co, vdw)
            assert (got is None) == (ref is None)
            if ref is not None:
                np.testing.assert_allclose(got, ref, atol=HOST, rtol=0)


def test_objectives(system):
    """The three scipy objectives on the CPU equal the JAX package's
    (tolerance EXACT); without a card their default device raises."""
    el, co = system
    co = co - np.asarray(ju.center_of_mass(el, co))
    cases = [
        ("correct_pore_diameter", np.array([0.3, -0.2, 0.1]), (el, co)),
        ("optimise_xy", np.array([0.3, -0.2]), (0.1, el, co)),
        ("optimise_z", [0.4], (0.2, -0.1, el, co)),
    ]
    for name, x, args in cases:
        got = getattr(tu, name)(x, *args, device="cpu")
        assert got == pytest.approx(getattr(ju, name)(x, *args), abs=EXACT)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                getattr(tu, name)(x, *args)
