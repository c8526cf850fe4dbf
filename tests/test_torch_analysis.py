"""The slice end to end: ``MolecularSystem.load_file(...)
.system_to_molecule().full_analysis()`` in pywindow_torch against
pywindow_tpu on the same structure, and against the BASELINE.md goldens.

Tolerances (float64):

* 1e-8 Å for everything computed without an optimiser (COM, weight,
  maximum/average/pore diameters, volumes) — measured ~1e-13;
* 1e-4 Å for what the FD-driven optimisers produce (optimised pore
  centre and diameter, window diameters and centres): scipy's
  h = 1e-8 forward differences amplify the last-bit differences
  between XLA's fused arithmetic and torch's by 1e8, so on plateau
  ridges the two stop at neighbouring points (measured up to 5.4e-5 Å
  on YAQHOQ's optimised centre) — the same class of difference the JAX
  package documents between its own batched and serial runs
  (docs/design.md, "Batched vs serial determinism");
* window counts equal.

Float32 (the configuration the port runs on CUDA): < 0.01 Å against
both pywindow_tpu in float32 and the goldens.
"""

import numpy as np
import pytest

import pywindow_torch as pt
import pywindow_tpu as pw
from pywindow_torch import config as tconfig
from tests.conftest import DATA, load_structure

EXACT = 1e-8
OPTIMISED = 1e-4

#: BASELINE.md goldens (reference tests and example scripts)
GOLD = {
    "PUDXES": {
        "centre_of_mass": [12.4, 12.4, 12.4],
        "maximum_diameter": 22.179369990077188,
        "average_diameter": 13.832017514255472,
        "pore_diameter": 5.397020177310022,
        "pore_volume": 82.31154385154417,
        "pore_diameter_opt": 5.397020177310022,
        "windows": [3.63778746, 3.63562103, 3.63707237, 3.62896512],
    },
    "YAQHOQ": {
        "pore_diameter": 3.61015,
        "pore_diameter_opt": 3.62898,
        "maximum_diameter": 10.49519,
        "windows": None,
    },
    "BATVUP": {
        "pore_diameter": 4.83653,
        "pore_diameter_opt": 4.95249,
        "windows": [3.72938, 3.34146],
    },
}


def _port(name):
    return pt.MolecularSystem.load_file(DATA / f"{name}.xyz").system_to_molecule()


def _jax(name):
    elements, coords = load_structure(name)
    return pw.Molecule({"elements": elements, "coordinates": coords})


def _windows(props):
    w = props["windows"]["diameters"]
    return None if w is None else np.asarray(w)


def _check_against_gold(props, gold, tol):
    for key, value in gold.items():
        if key == "windows":
            got = _windows(props)
            if value is None:
                assert got is None
            else:
                np.testing.assert_allclose(np.sort(got), np.sort(value), atol=tol)
            continue
        got = props[key]
        if isinstance(got, dict):
            got = got["diameter"]
        np.testing.assert_allclose(got, value, atol=tol)


@pytest.mark.parametrize("name", ["PUDXES", "YAQHOQ", "BATVUP"])
def test_full_analysis_float64_matches_jax_and_goldens(name):
    mol, jmol = _port(name), _jax(name)
    props, ref = mol.full_analysis(device="cpu"), jmol.full_analysis()
    assert mol.MW == pytest.approx(jmol.MW, abs=EXACT)
    np.testing.assert_allclose(
        props["centre_of_mass"], ref["centre_of_mass"], atol=EXACT, rtol=0
    )
    for key in ("average_diameter", "pore_volume"):
        assert props[key] == pytest.approx(ref[key], abs=EXACT)
    for key in ("maximum_diameter", "pore_diameter"):
        assert props[key]["diameter"] == pytest.approx(ref[key]["diameter"], abs=EXACT)
    # the atoms realising the maximum diameter: the same pair or, on a
    # symmetric cage where pairs tie to the last bit, one of equal length
    from pywindow_torch import tables

    coords = np.asarray(mol.coordinates)
    vdw = tables.ELEMENT_VDW[tables.element_ids(mol.elements)]
    i, j = props["maximum_diameter"]["atom_1"], props["maximum_diameter"]["atom_2"]
    length = np.linalg.norm(coords[i] - coords[j]) + vdw[i] + vdw[j]
    assert length == pytest.approx(ref["maximum_diameter"]["diameter"], abs=EXACT)

    opt, ref_opt = props["pore_diameter_opt"], ref["pore_diameter_opt"]
    assert opt["diameter"] == pytest.approx(ref_opt["diameter"], abs=OPTIMISED)
    np.testing.assert_allclose(
        opt["centre_of_mass"], ref_opt["centre_of_mass"], atol=OPTIMISED, rtol=0
    )
    assert props["pore_volume_opt"] == pytest.approx(
        ref["pore_volume_opt"], rel=OPTIMISED
    )
    got_w, ref_w = _windows(props), _windows(ref)
    assert (got_w is None) == (ref_w is None)
    if got_w is not None:
        assert len(got_w) == len(ref_w)
        order_t, order_j = np.argsort(got_w), np.argsort(ref_w)
        np.testing.assert_allclose(got_w[order_t], ref_w[order_j], atol=OPTIMISED, rtol=0)
        np.testing.assert_allclose(
            np.asarray(props["windows"]["centre_of_mass"])[order_t],
            np.asarray(ref["windows"]["centre_of_mass"])[order_j],
            atol=OPTIMISED, rtol=0,
        )
    _check_against_gold(props, GOLD[name], OPTIMISED)


def test_full_analysis_float32_stable_matches_jax_and_goldens(monkeypatch):
    """The CUDA configuration (float32 pipeline, stable optimisers) run
    on the CPU: PUDXES within the 0.01 Å contract of pywindow_tpu's own
    float32 stable run and of the goldens."""
    monkeypatch.setenv("PYWINDOW_TORCH_FORCE_F32", "1")
    monkeypatch.setenv("PYWINDOW_TPU_FORCE_F32", "1")
    mol = _port("PUDXES")
    props = mol.full_analysis(device="cpu")
    ref = _jax("PUDXES").full_analysis()
    for key in ("maximum_diameter", "pore_diameter", "pore_diameter_opt"):
        assert props[key]["diameter"] == pytest.approx(ref[key]["diameter"], abs=0.01)
    assert props["average_diameter"] == pytest.approx(ref["average_diameter"], abs=0.01)
    np.testing.assert_allclose(
        np.sort(_windows(props)), np.sort(_windows(ref)), atol=0.01
    )
    _check_against_gold(props, GOLD["PUDXES"], 0.01)
    assert mol.calculate_windows().dtype == np.float32


def test_escalations_and_getters():
    """All three host escalations of ``analyze`` reproduce the default
    run: an overflowing open-ray cap, a saturated window cap, and fast
    optimiser budgets that cap out."""
    base = _port("PUDXES").full_analysis(device="cpu")
    cfg = pt.AnalysisConfig(
        open_cap_frac=0.05, max_windows=2, fast_opt_maxiter=1, fast_nm_maxiter=2
    )
    mol = pt.Molecule(_port("PUDXES").mol, config=cfg)
    props = mol.full_analysis(device="cpu")
    np.testing.assert_allclose(
        np.sort(_windows(props)), np.sort(_windows(base)), atol=1e-10
    )
    assert not any(k.startswith("_") for k in props)
    assert mol.calculate_pore_diameter_opt() == pytest.approx(
        base["pore_diameter_opt"]["diameter"], abs=1e-10
    )
    fresh = pt.Molecule(_port("YAQHOQ").mol, device="cpu")
    assert fresh.calculate_windows() is None  # runs the analysis itself
    assert fresh.calculate_pore_volume() == pytest.approx(
        4.0 / 3.0 * np.pi * (fresh.pore_diameter / 2) ** 3
    )
    assert fresh.calculate_maximum_diameter() == pytest.approx(10.49519, abs=1e-4)


@pytest.mark.parametrize(
    "fields",
    [
        {"z_second_mini": True},
        {"lb_z": False},
        {"pore_opt": False},
        {"open_cap_frac": 1.0},
    ],
    ids=lambda f: next(iter(f)),
)
def test_config_variants_match_jax(fields):
    """The config's other branches, carried across from the JAX
    package's AnalysisConfig with ``convert.config_from_dict``."""
    import dataclasses

    from pywindow_tpu.config import AnalysisConfig as JaxConfig
    from tests.test_torch_parity import torch_config

    jcfg = dataclasses.replace(JaxConfig(), **fields)
    elements, coords = load_structure("BATVUP")
    ref = pw.Molecule({"elements": elements, "coordinates": coords}, config=jcfg).full_analysis()
    props = pt.Molecule(
        {"elements": elements, "coordinates": coords}, config=torch_config(jcfg)
    ).full_analysis(device="cpu")
    opt, ref_opt = props["pore_diameter_opt"], ref["pore_diameter_opt"]
    np.testing.assert_allclose(
        opt["centre_of_mass"], ref_opt["centre_of_mass"], atol=OPTIMISED, rtol=0
    )
    got_w, ref_w = _windows(props), _windows(ref)
    assert len(got_w) == len(ref_w)
    np.testing.assert_allclose(np.sort(got_w), np.sort(ref_w), atol=OPTIMISED, rtol=0)


def test_dtype_policy(monkeypatch):
    import torch

    assert tconfig.default_dtype("cpu") == torch.float64
    assert tconfig.default_dtype("cuda") == torch.float32
    monkeypatch.setenv("PYWINDOW_TORCH_FORCE_F32", "1")
    assert tconfig.default_dtype("cpu") == torch.float32
    assert tconfig.pore_opt_mode(torch.float32) == "stable"
    assert tconfig.window_opt_mode(torch.float64) == "classic"
