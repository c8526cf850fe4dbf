"""Every name in BENCHMARK.json is found as a file, and the file keeps
the contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from _tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and all(NAME.match(k) for k in conf["reduced"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"]
    assert all(k in data for k in conf["reduced"])
    assert 1 <= len(conf["why"]) <= 200 and 1 <= len(conf["source"]) <= 200
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    assert (ROOT / "portbench" / "workloads" / f"{cell['name']}.json").is_file()
    assert (ROOT / "portbench" / "drivers" / f"{cell['traffic']}.py").is_file()
    reported = [m for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert any(m["name"] == "setup_s" for m in reported) and len(reported) >= 2
    assert any(cell["name"] in m.get("workloads", []) for m in BENCH["per_layer"])


@pytest.mark.parametrize(
    "metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"]
)
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert {"layer", "moves"} <= set(metric)
        moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moves.get("workloads", cells))


def test_pairs_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)
