"""The reference's embedded validation suites on the port.

``tests/test_validation_suite.py`` holds five cages with 0/2/3/4/6
windows (``val_case_1-5``) and five average-diameter cases
(``avg_case_1-5``) against ``pywindow_tpu``; here the same fixtures and
goldens go through ``pywindow_torch.Molecule`` at the same tolerances
(windows 0.01 Å, 0.05 Å for case_5, whose goldens wobble with the scipy
version; average diameters 1e-3 Å), windows and their centres matched
order-insensitively.  Two legs:

- ``float64``: the CPU's own dtypes, the classic scipy-parity drivers
  (``device="cpu"``).  case_3 (NUXHIZ) is a strict expected failure:
  the classic FD driver is chaotic there (ROADMAP Q3.4);
- ``card dtypes``: ``PYWINDOW_TORCH_FORCE_F32=1``, the card's
  configuration on the CPU (a float32 pipeline, the stable drivers on
  float64 state), every case.
"""

import json

import numpy as np
import pytest

import pywindow_torch as pt
from tests.conftest import DATA, load_xyz

GOLDEN = json.loads((DATA / "validation_golden.json").read_text())

NUXHIZ_XFAIL = pytest.mark.xfail(
    strict=True,
    reason=(
        "ROADMAP Q3.4: the float64 classic FD pore driver is chaotic on "
        "NUXHIZ (val_case_3): the port stops at pore_opt 8.96024 and one "
        "window reads 7.8508 A against the golden 7.9039 (0.053 A), where "
        "the JAX package lands at 8.96819; the two COMs differ by 0-2 ulp, "
        "and from the JAX COM the port lands at 8.96825, the golden's basin"
    ),
)

WINDOW_CASES = [f"case_{i}" for i in range(1, 6)]
AVG_CASES = [f"avg_case_{i}" for i in range(1, 6)]


def _molecule(case: str) -> pt.Molecule:
    prefix = "" if case.startswith("avg_") else "val_"
    elements, coords = load_xyz(DATA / f"{prefix}{case}.xyz")
    return pt.Molecule({"elements": elements, "coordinates": coords}, case, 0, device="cpu")


def _check_windows(case: str) -> pt.Molecule:
    mol = _molecule(case)
    diameters = mol.calculate_windows()
    gold = GOLDEN[case]["windows_diam"]
    if gold is None:
        assert diameters is None
        return mol
    tol = 0.05 if case == "case_5" else 0.01
    assert diameters is not None and len(diameters) == len(gold)
    np.testing.assert_allclose(np.sort(diameters), np.sort(gold), atol=tol)
    # centres match the golden set pairwise (order-insensitive)
    coms = mol.properties["windows"]["centre_of_mass"]
    taken = set()
    for g in np.asarray(GOLDEN[case]["windows_coms"]):
        dists = np.linalg.norm(coms - g, axis=1)
        order = np.argsort(dists)
        j = next(int(k) for k in order if int(k) not in taken)
        taken.add(j)
        np.testing.assert_allclose(coms[j], g, atol=tol)
    return mol


def _check_average(case: str) -> pt.Molecule:
    mol = _molecule(case)
    avg = mol.calculate_average_diameter()
    assert avg == pytest.approx(GOLDEN[case]["average_diam"], abs=1e-3)
    return mol


def _check(case: str) -> pt.Molecule:
    """The case's goldens; returns the analysed molecule."""
    if case.startswith("avg_"):
        return _check_average(case)
    return _check_windows(case)


@pytest.mark.parametrize(
    "case",
    [
        pytest.param(c, marks=[NUXHIZ_XFAIL] if c == "case_3" else [])
        for c in WINDOW_CASES + AVG_CASES
    ],
)
def test_validation_suite_float64(case, monkeypatch):
    monkeypatch.delenv("PYWINDOW_TORCH_FORCE_F32", raising=False)
    _check(case)


@pytest.mark.parametrize("case", WINDOW_CASES + AVG_CASES)
def test_validation_suite_card_dtypes(case, monkeypatch):
    monkeypatch.setenv("PYWINDOW_TORCH_FORCE_F32", "1")
    pore = _check(case).properties["pore_diameter"]["diameter"]
    assert float(np.float32(pore)) == pore  # the float32 pipeline ran
