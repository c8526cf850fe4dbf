"""``python -m pywindow_torch`` against ``python -m pywindow_tpu``: the
same commands on the same files, the JSON they write compared at the
tolerances of tests/test_torch_batch.py (1e-8 Å where no optimiser
runs, 1e-4 Å for optimised centres and windows), on the CPU in float64
(``--device cpu``).  Without a card and without ``--device cpu`` the
command fails instead of falling back to the CPU."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from pywindow_torch.__main__ import main
from pywindow_tpu.__main__ import main as jmain
from tests.conftest import DATA

EXACT = 1e-8
OPTIMISED = 1e-4
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _close(got, ref):
    for key in ("average_diameter", "pore_volume"):
        assert got[key] == pytest.approx(ref[key], abs=EXACT)
    for key in ("maximum_diameter", "pore_diameter"):
        assert got[key]["diameter"] == pytest.approx(ref[key]["diameter"], abs=EXACT)
    np.testing.assert_allclose(got["centre_of_mass"], ref["centre_of_mass"], atol=EXACT, rtol=0)
    assert got["pore_diameter_opt"]["diameter"] == pytest.approx(
        ref["pore_diameter_opt"]["diameter"], abs=OPTIMISED
    )
    gw, rw = got["windows"]["diameters"], ref["windows"]["diameters"]
    assert (gw is None) == (rw is None)
    if gw is not None:
        np.testing.assert_allclose(np.sort(gw), np.sort(rw), atol=OPTIMISED, rtol=0)


@pytest.mark.parametrize("name", ["PUDXES", "YAQHOQ"])
def test_analyze_matches_jax_cli(name, tmp_path):
    out, jout = tmp_path / "torch.json", tmp_path / "jax.json"
    main(["analyze", str(DATA / f"{name}.xyz"), "-o", str(out), "--device", "cpu"])
    jmain(["analyze", str(DATA / f"{name}.xyz"), "-o", str(jout)])
    got, ref = json.loads(out.read_text()), json.loads(jout.read_text())
    assert sorted(got) == sorted(ref)
    _close(got, ref)


def test_trajectory_matches_jax_cli(tmp_path):
    """Frames 9 and 10 of the CC3 HISTORY fixture (two frames on which
    both packages' float64 classic drivers stop at the same point, see
    tests/test_torch_batch.py)."""
    out, jout = tmp_path / "torch.json", tmp_path / "jax.json"
    args = [
        "trajectory", str(DATA / "HISTORY_singlemol_short"), "--frames", "9:11",
        "--forcefield", "OPLS", "--swap", "he=H",
    ]
    main([*args, "-o", str(out), "--device", "cpu"])
    jmain([*args, "-o", str(jout)])
    got, ref = json.loads(out.read_text()), json.loads(jout.read_text())
    assert sorted(got) == sorted(ref) == ["10", "9"]
    for frame in got:
        _close(got[frame]["0"], ref[frame]["0"])


def test_no_card_and_no_device_flag_fails():
    """The card hidden (``CUDA_VISIBLE_DEVICES=""``), the default device
    raises."""
    proc = subprocess.run(
        [sys.executable, "-m", "pywindow_torch", "analyze", str(DATA / "YAQHOQ.xyz")],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
