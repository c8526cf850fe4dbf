"""The port's benchmark, ``bench_torch.py`` and ``python -m pywindow_torch
bench``, on the CPU: the command line, the no-card error, every row at
a tiny size through the same code the card runs, the synthesised
trajectories against their fixtures, and the first frame of the
end-to-end row against ``pywindow_tpu``'s ``DLPOLY.analysis_batched``
at the tolerances of tests/test_torch_cli.py (float64, 1e-8 Å where no
optimiser runs, 1e-4 Å where one does)."""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import bench_torch
import chip_smoke
import pywindow_torch as pt
import pywindow_tpu as pw
from pywindow_torch.__main__ import main as cli
from tests.test_torch_cli import _close

#: the rows at a tiny size: 20 kernel frames (the fixture once), 40
#: end-to-end frames in chunks of 20, 2 frames of each large system
TINY = {
    "kernel_frames": 20, "e2e_frames": 40, "e2e_batch": 20, "big_frames": 2,
    "mibqar_frames": 2, "mibqar_batch": 2, "reps": 2,
}
RECORD_KEYS = {
    "metric", "unit", "device", "sizes", "gate", "kernel", "kernels", "pipeline", "e2e",
    "mibqar_kernel", "reymal_kernel", "mibqar_e2e", "reference_fps", "vs_baseline", "value",
    "reduced",
}
ROW_KEYS = {"frames", "reps", "rep_seconds", "median_s", "min_s", "max_s", "fps_median", "fps_min", "fps_max"}
CPU = torch.device("cpu")


def test_cli_has_bench(capsys):
    with pytest.raises(SystemExit) as exc:
        cli(["bench", "--help"])
    assert exc.value.code == 0
    assert "--device" in capsys.readouterr().out


def test_bench_passes_the_device_to_the_script(monkeypatch):
    seen = {}

    def run_path(path, run_name):
        seen.update(path=path, run_name=run_name, argv=list(sys.argv))

    monkeypatch.setattr(runpy, "run_path", run_path)
    argv = list(sys.argv)
    cli(["bench", "--device", "cpu"])
    assert seen == {
        "path": str(bench_torch.ROOT / "bench_torch.py"), "run_name": "__main__",
        "argv": [str(bench_torch.ROOT / "bench_torch.py"), "--device", "cpu"],
    }
    assert sys.argv == argv


def test_bench_without_a_card_raises_before_any_work(monkeypatch):
    def no_work(*args, **kwargs):
        raise AssertionError("the bench started without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(runpy, "run_path", no_work)
    monkeypatch.setattr(bench_torch, "run", no_work)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli(["bench"])
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        bench_torch.main([])


def test_bench_outside_a_checkout(monkeypatch, tmp_path):
    import pywindow_torch.__main__ as entry

    monkeypatch.setattr(entry, "BENCH", tmp_path / "bench_torch.py")
    with pytest.raises(SystemExit, match="run it from a checkout"):
        cli(["bench", "--device", "cpu"])


def test_bench_rows_on_the_cpu(capsys):
    before = os.environ.get("PYWINDOW_TORCH_FORCE_F32")
    bench_torch.main(["--device", "cpu"], **TINY)
    assert os.environ.get("PYWINDOW_TORCH_FORCE_F32") == before
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines[-1].encode()) < 1000
    head = json.loads(lines[-1])
    assert set(head) == {"metric", "value", "unit", "spread", "reps", "kernel_fps", "device"}
    assert head["metric"] == "cc3_full_analysis_throughput" and head["unit"] == "frames/s"
    assert head["value"] > 0 and head["kernel_fps"] > 0
    assert head["spread"][0] <= head["value"] <= head["spread"][1]
    assert head["reps"] == 2 and head["device"] == "cpu"
    record = json.loads(lines[-2])
    assert set(record) == RECORD_KEYS
    assert record["value"] == head["value"]
    assert record["gate"]["pass"] and set(record["gate"]["systems"]) == set(chip_smoke.GOLD)
    assert all(s["worst"] < 0.01 for s in record["gate"]["systems"].values())
    for row, frames in (
        ("kernel", 20), ("e2e", 40), ("mibqar_kernel", 2), ("reymal_kernel", 2), ("mibqar_e2e", 2),
    ):
        assert ROW_KEYS <= set(record[row]), row
        assert record[row]["frames"] == frames and len(record[row]["rep_seconds"]) == 2
    assert len(record["e2e"]["warmup_s"]) == 1 and len(record["mibqar_e2e"]["warmup_s"]) == 2
    assert record["kernels"] is None and record["pipeline"] is None  # no kernel runs on the CPU
    assert record["reference_fps"] is None and record["vs_baseline"] is None
    assert record["reduced"] == []
    assert record["device"]["platform"] == "cpu"


def test_failed_gate_prints_its_report_and_exits(monkeypatch, capsys):
    report = {"tol": 0.01, "pass": False, "systems": {"NUXHIZ": {"worst": 0.05}}}
    monkeypatch.setattr(chip_smoke, "gate_report", lambda device: report)
    with pytest.raises(SystemExit) as exc:
        bench_torch.run(CPU, **TINY)
    assert exc.value.code == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"error": "accuracy gate failed", **report}


def test_a_failed_row_is_not_caught(monkeypatch):
    """A row whose sanity check fails ends the bench (the CC3 pore is
    ~5 Å, not 50)."""
    monkeypatch.setattr(chip_smoke, "gate_report", lambda device: {"pass": True})
    monkeypatch.setattr(bench_torch, "CC3_PORE", 50.0)
    with pytest.raises(AssertionError, match="pore diameter"):
        bench_torch.run(CPU, **{**TINY, "reps": 1})


def test_kernel_batch_is_cut_to_what_fits(monkeypatch):
    """More frames than ``max_safe_batch`` allows: the largest multiple
    of the distinct systems that fits, recorded as reduced."""
    import pywindow_torch.parallel.batch as batch

    systems = bench_torch.fixture_frames()
    monkeypatch.setattr(batch, "max_safe_batch", lambda *args: 50)
    mols, sizes, frames, reduced = bench_torch.kernel_batch(systems, 8640, CPU)
    assert frames == 40 and mols.coords.shape[0] == 40
    assert reduced == "8640 frames do not fit (max_safe_batch 50): 40"


def test_synthesised_cc3_history_cycles_the_fixture():
    path = chip_smoke.synth_history(40)
    assert path.parent == chip_smoke.ROOT / "build" and path.name.startswith("HISTORY_cc3_40_")
    assert chip_smoke.synth_history(40) == path
    fixture = pt.DLPOLY(chip_smoke.HISTORY).get_frames()
    traj = pt.DLPOLY(path)
    assert traj.no_of_frames == 40
    for k, frame in traj.get_frames().items():
        ref = fixture[k % 20].system
        np.testing.assert_array_equal(frame.system["coordinates"], ref["coordinates"])
        np.testing.assert_array_equal(frame.system["atom_ids"], ref["atom_ids"])
    steps = [int(ln.split()[1]) for ln in path.read_text().splitlines() if ln.startswith("timestep")]
    assert len(steps) == 40 and all(a < b for a, b in zip(steps, steps[1:]))


def test_synthesised_mibqar_history_holds_the_pdb():
    path = bench_torch.synth_mibqar(3)
    assert path.name.startswith("HISTORY_mibqar_3_")
    elements, coords = chip_smoke.load_pdb_atoms(bench_torch.MIBQAR)
    traj = pt.DLPOLY(path)
    assert traj.no_of_frames == 3
    for frame in traj.get_frames().values():
        assert list(frame.system["atom_ids"]) == list(elements)
        np.testing.assert_allclose(frame.system["coordinates"], coords, atol=1e-4, rtol=0)


def test_end_to_end_row_matches_the_jax_sweep():
    """The first frame of the end-to-end row (float64 on the CPU) against
    ``pywindow_tpu``'s sweep of the same trajectory's 20 distinct frames
    (the same sampling pin)."""
    path = chip_smoke.synth_history(40)
    row, out = bench_torch.e2e_row(path, 40, 20, CPU, [], bench_torch.FF, bench_torch.CC3_PORE, reps=1)
    assert row["reps"] == 1 and row["warmup_s"] == [] and sorted(out) == list(range(40))
    ref = pw.DLPOLY(path)
    ref.analysis_batched(frames=list(range(20)), batch_size=20, **bench_torch.FF)
    _close(out[0]["0"], ref.analysis_output[0]["0"])
