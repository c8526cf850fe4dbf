"""The default device: ``config.default_device`` reads
``PYWINDOW_TORCH_DEVICE`` at each call (the port's counterpart of the
JAX package's ``jax_platforms``), and every entry point called without
a device resolves it there.  Unset, the default is the card, which
raises here; the tests set the variable with ``monkeypatch`` only, so
it never outlives a test."""

import os

import numpy as np
import pytest
import torch

import pywindow_torch as pt
from pywindow_torch import config, utilities
from pywindow_torch.ops import analysis
from pywindow_torch.parallel import batch, mesh
from tests.conftest import DATA, load_structure

ENV = "PYWINDOW_TORCH_DEVICE"
NO_CARD = "no CUDA device is available"


def _molecule():
    elements, coords = load_structure("YAQHOQ")
    return pt.Molecule({"elements": elements, "coordinates": coords}, "YAQHOQ")


def _system():
    return pt.MolecularSystem.load_file(DATA / "YAQHOQ.xyz")


#: entry points called without a device (each returns or raises)
ENTRY_POINTS = {
    "Molecule.full_analysis": lambda: _molecule().full_analysis(),
    "Molecule.calculate_pore_diameter": lambda: _molecule().calculate_pore_diameter(),
    "analysis.analyze": lambda: analysis.analyze(*load_structure("YAQHOQ")),
    "batch.analyze_batch": lambda: batch.analyze_batch([load_structure("YAQHOQ")]),
    "mesh.frame_device": lambda: mesh.frame_device(),
    "utilities.max_dim": lambda: utilities.max_dim(*load_structure("YAQHOQ")),
    "XYZ.analysis_batched": lambda: pt.XYZ(DATA / "YAQHOQ.xyz").analysis_batched(),
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="the no-card raise needs a machine without a card")
@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_unset_default_is_the_card_and_raises(name, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert config.default_device() == torch.device("cuda")
    with pytest.raises(RuntimeError, match=NO_CARD) as info:
        ENTRY_POINTS[name]()
    assert "device='cpu'" in str(info.value)


def test_cpu_default_runs_like_device_cpu_bit_for_bit(monkeypatch):
    explicit = _molecule().full_analysis(device="cpu")
    monkeypatch.setenv(ENV, "cpu")
    mol = _molecule()
    props = mol.full_analysis()
    assert mol.device is None  # resolved per call, not stored
    assert props.keys() == explicit.keys()
    for key, want in explicit.items():
        got = props[key]
        if isinstance(want, dict):
            for k, v in want.items():
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=f"{key}.{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=key)
    assert np.asarray(props["pore_diameter"]["diameter"]).dtype == np.float64
    # the getters and the batch layer resolve the same default
    assert _molecule().calculate_pore_diameter() == explicit["pore_diameter"]["diameter"]
    sys_ = _system()
    sys_.make_modular()
    res = sys_.analyze_molecules()
    assert res[0]["pore_diameter"]["diameter"] == explicit["pore_diameter"]["diameter"]
    assert sys_.molecules[0].device is None


@pytest.mark.parametrize("value", ["gpu", "CPU", "cuda:", "cuda:x", "cpu:0", "", "mps"])
def test_bad_value_raises(value, monkeypatch):
    monkeypatch.setenv(ENV, value)
    with pytest.raises(ValueError, match=ENV):
        config.default_device()
    with pytest.raises(ValueError, match=ENV):
        _molecule().full_analysis()


@pytest.mark.parametrize(("value", "want"), [("cpu", "cpu"), ("cuda", "cuda"), ("cuda:3", "cuda:3")])
def test_accepted_values(value, want, monkeypatch):
    monkeypatch.setenv(ENV, value)
    assert config.default_device() == torch.device(want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the no-card raise needs a machine without a card")
def test_explicit_device_overrides_the_variable(monkeypatch):
    monkeypatch.setenv(ENV, "cuda")
    props = _molecule().full_analysis(device="cpu")
    assert np.isfinite(props["pore_diameter"]["diameter"])
    monkeypatch.setenv(ENV, "cpu")
    with pytest.raises(RuntimeError, match=NO_CARD):
        _molecule().full_analysis(device="cuda")
    with pytest.raises(RuntimeError, match=NO_CARD):
        batch.analyze_batch([load_structure("YAQHOQ")], device="cuda:0")


def test_variable_does_not_outlive_the_test():
    before = os.environ.get(ENV)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ENV, "cpu")
        assert config.default_device() == torch.device("cpu")
    assert os.environ.get(ENV) == before
    assert before is None or before == "cuda" or before.startswith("cuda:")
