"""Each driver end to end at a tiny size on the CPU, each run in a fresh
interpreter as a benchmark run is (a process joins one process group
once):
a run comes out correct and reports its cell's metrics; the measurement
path refuses without a card; every fault a cell can have comes out not
correct."""

from __future__ import annotations

import json

import pytest
import torch

from _tiny import ROOT, SECONDS, TINY, fresh
from portbench import faults, run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

_RUN = """
import json, torch
torch.set_num_threads(2)
from portbench import run
out = run.run_cell({cell!r}, 2**31 + 3, {seconds}, {trace}, device="cpu", overrides={tiny!r})
print(json.dumps(out))
"""

_FAULT = """
import json, torch
torch.set_num_threads(2)
from portbench import faults
print(json.dumps(faults.run_with({fault!r}, {cell!r}, 17, "cpu", {tiny!r}, seconds={seconds})))
"""
FAULTS = [(c, f) for c in CELLS for f in faults.applicable(c)]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell, trace):
    out = fresh(_RUN.format(cell=cell, trace=trace, tiny=TINY[cell], seconds=SECONDS.get(cell, 0.5)))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    e2e, per_layer = run.cell_metrics(BENCH, next(w for w in BENCH["workloads"] if w["name"] == cell))
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in e2e}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        # device readings (rooflines, kernels, busy time) need the card
        assert set(out["metrics"]) <= {m["name"] for m in per_layer}
        assert out["device"]["window_s"] > 0 and "breakdown" in out


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault):
    got = fresh(_FAULT.format(fault=fault, cell=cell, tiny=TINY[cell], seconds=SECONDS.get(cell, 0.2)))
    assert not got["correct"], got


def test_no_card_refuses(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "cc3_md.sweep", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_refuse(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.main(["--workload", "cc3_md_4rank.sweep", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
