"""The plain reference against what is known of the generated inputs:
the published goldens of PUDXES, the periodic cell's 8 whole cages, and
a control (the reference in lower precision) that fails the limits."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from _tiny import ROOT
from portbench import compare
from portbench.inputs import fixtures, periodic
from portbench.reference import molecules, pipeline

#: pywindow's published values for PUDXES (BASELINE.md)
PUDXES = {"maximum_diameter": 22.179369990077188, "pore_diameter": 5.397020177310022,
          "pore_diameter_opt": 5.397020177310022, "average_diameter": 13.832017514255472}
WINDOWS = [3.62896512, 3.63562103, 3.63707237, 3.63778746]


def _pudxes():
    lines = (fixtures.DATA / "PUDXES.xyz").read_text().splitlines()[2:]
    els = np.array([ln.split()[0] for ln in lines])
    xyz = np.array([[float(v) for v in ln.split()[1:4]] for ln in lines])
    return els, xyz


def test_reference_meets_the_goldens():
    els, xyz = _pudxes()
    sizes = pipeline.static_sizes(pipeline.max_dim_host(els, xyz), pipeline.CFG)
    r = pipeline.analyse([(els, xyz)], sizes, "cpu")[0]
    for key, want in PUDXES.items():
        assert abs(r[key] - want) < 0.01, key
    assert np.allclose(r["centre_of_mass"], 12.4, atol=1e-4)
    assert np.allclose(np.sort(r["window_diameters"]), WINDOWS, atol=0.01)


def test_reference_rebuild_gives_whole_cages(tmp_path):
    t = periodic.write(tmp_path / "p.pdb", 2, 5, "system_periodic.pdb")
    els = molecules.elements(t.names, None, "DLF")
    for f in range(2):
        cages = molecules.rebuild(els, t.coords[f], t.edge)
        assert [len(e) for e, _ in cages] == [168] * 8
        for e, c in cages:  # whole: every atom within a bond of another
            d = np.sqrt(((c[:, None] - c[None]) ** 2).sum(-1)) + np.eye(len(c)) * 99
            assert d.min(1).max() < 2.0
            assert np.ptp(c, axis=0).max() < 0.9 * 24.8


def test_control_fails_a_limit():
    """The reference in bfloat16 with float32 optimisers, in the
    program's place, reads above a limit of the sweep's."""
    limits = json.loads((ROOT / "portbench/workloads/cc3_md.sweep.json").read_text())["limits"]
    els, xyz = _pudxes()
    sizes = pipeline.static_sizes(pipeline.max_dim_host(els, xyz), pipeline.CFG)
    ref = pipeline.analyse([(els, xyz)], sizes, "cpu")[0]
    low = pipeline.analyse([(els, xyz)], sizes, "cpu", torch.bfloat16, torch.float32)[0]
    tally = compare.Tally()
    compare.compare_all(tally, {0: [compare.as_answer(low)]}, {0: [ref]})
    assert any(c["value"] > c["limit"] for c in tally.checks(limits)), tally.values


@pytest.mark.parametrize("keys,field,want", [
    (["ni", "ca", "he", "hc"], "OPLS", ["N", "C", "H", "H"]),
    (["N1", "C12", "H3"], "DLF", ["N", "C", "H"]),
])
def test_elements(keys, field, want):
    swap = {"he": "H"} if field == "OPLS" else None
    assert molecules.elements(keys, swap, field).tolist() == want
