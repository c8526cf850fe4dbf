"""``pywindow_torch.profiling``'s spans at the layer boundaries, on the
CPU without a process group: the sweep's set-up, retries and pipeline
stages, the chunk ids that follow a chunk across the sweep's threads in
a Chrome trace, the single request's passes and re-runs, the collector's
passes, the periodic rebuild's split, the ranks' barrier, the off path
(one shared no-op, no collector hook, no counter), and the benchmark's
readers of these spans."""

import gc
import json

import numpy as np
import pytest
import torch

import pywindow_torch as pt
from pywindow_torch import profiling
from pywindow_torch.ops import analysis
from pywindow_torch.parallel import batch, distributed
from pywindow_torch.profiling import METRICS
from tests.conftest import DATA, load_xyz

HISTORY = DATA / "HISTORY_singlemol_short"
FF = {"swap_atoms": {"he": "H"}, "forcefield": "OPLS"}
PIPELINE = ("pipeline.scalars", "pipeline.average", "pipeline.pore", "pipeline.pore_opt",
            "pipeline.windows", "pipeline.pack")


@pytest.fixture
def profiling_on():
    saved = profiling.enabled()
    profiling.enable()
    METRICS.reset()
    yield
    profiling.enable(saved)
    METRICS.reset()


def _two_frames():
    el, co = load_xyz(DATA / "YAQHOQ.xyz")
    coords = np.stack([co, co + 0.01])

    def decode_slab(lo, hi, out64=None, out32=None):
        (out64 if out64 is not None else out32)[...] = coords[lo:hi]
        return np.full(hi - lo, 10.6)

    return el, coords, decode_slab


def test_sweep_spans_per_chunk(profiling_on):
    """A two-chunk streamed sweep: its set-up and its drain once; the
    retry scan and the pipeline's stages once a chunk."""
    el, _, decode_slab = _two_frames()
    batch.sweep_stream(el, 2, decode_slab, lambda pos, res: None, batch_size=1, device="cpu")
    calls = METRICS.snapshot()["stage_calls"]
    assert calls["sweep_open"] == 1
    assert calls["sweep_drain"] == 1
    for name in ("sweep_retry", *PIPELINE):
        assert calls[name] == 2, name


def _annotations(trace_dir) -> list[dict]:
    (path,) = trace_dir.glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _fake_pipeline(monkeypatch, overflow: list | None = None):
    """A stand-in for the device pipeline (zero rows; ``overflow``: the
    open-ray overflow flag of each call's rows, in turn): the span tests
    that trace every CPU op then run in a blink."""

    def run(mols, sizes, cfg):
        flat = torch.zeros((mols.coords.shape[0], analysis.packed_size(cfg.max_windows)))
        if overflow:
            flat[:, 13] = overflow.pop(0)
        return flat

    monkeypatch.setattr(analysis, "run_pipeline", run)


def test_chunk_ids_follow_a_chunk_across_threads(profiling_on, tmp_path, monkeypatch):
    """A DL_POLY sweep of two one-frame chunks under ``trace``: every
    span carries the sweep's id; chunk 1's spans lie on the main thread
    (its dispatch), the decoder's (its slab) and the collector's (its
    fetch, dicts and retry scan)."""
    _fake_pipeline(monkeypatch)
    traj = pt.DLPOLY(HISTORY)
    with profiling.trace(tmp_path):
        traj.analysis_batched(frames=[0, 1], batch_size=1, device="cpu", **FF)
    notes = _annotations(tmp_path)
    (entry,) = [e for e in notes if e["name"] == "analysis_batched"]
    sweep = entry["args"]["sweep"]
    main = entry["tid"]
    chunk1 = [e for e in notes if e.get("args", {}).get("chunk") == 1]
    assert all(e["args"]["sweep"] == sweep for e in chunk1)
    threads = {e["name"]: e["tid"] for e in chunk1}
    assert threads["sweep_dispatch"] == main
    assert threads["sweep_decode"] != main
    assert threads["sweep_fetch"] not in (main, threads["sweep_decode"])
    assert threads["sweep_to_dicts"] == threads["sweep_retry"] == threads["sweep_fetch"]
    assert [e["name"] for e in notes if e["name"] == "sweep_open"] == ["sweep_open"] * 2


def test_analyze_books_its_pass(profiling_on):
    el, co = load_xyz(DATA / "YAQHOQ.xyz")
    analysis.analyze(el, co, device="cpu")
    calls = METRICS.snapshot()["stage_calls"]
    for name in ("analysis_enqueue", "analysis_fetch", "analysis_dict", *PIPELINE):
        assert calls[name] == 1, name
    assert "analysis_rerun" not in calls
    assert METRICS.counters["molecules_analysed"] == 1


def test_forced_overflow_books_a_rerun(profiling_on):
    """A compaction cap too small for a cage's open rays: each re-run is
    an ``analysis_rerun`` span, counted by reason, whose pass books its
    stages again; the request is one ``full_analysis`` span."""
    el, co = load_xyz(DATA / "avg_case_2.xyz")
    mol = pt.Molecule({"elements": el, "coordinates": co},
                      config=pt.AnalysisConfig(open_cap_frac=0.1))
    mol.full_analysis(device="cpu")
    snap = METRICS.snapshot()
    reruns = snap["counters"]["analysis_reruns.open_overflow"]
    assert reruns >= 1
    assert snap["stage_calls"]["analysis_rerun"] == reruns
    assert snap["stage_calls"]["analysis_enqueue"] == reruns + 1
    assert snap["stage_calls"]["full_analysis"] == 1


def test_rerun_reason_in_the_trace(profiling_on, tmp_path, monkeypatch):
    """In the Chrome trace a re-run carries its reason and its request's
    id, which the next request's spans do not share."""
    _fake_pipeline(monkeypatch, overflow=[1.0, 0.0, 0.0])
    el, co = load_xyz(DATA / "YAQHOQ.xyz")
    mol = pt.Molecule({"elements": el, "coordinates": co})
    with profiling.trace(tmp_path):
        mol.full_analysis(device="cpu")
        mol.full_analysis(device="cpu")
    notes = _annotations(tmp_path)
    first, second = [e["args"]["request"] for e in notes if e["name"] == "full_analysis"]
    assert first != second
    (rerun,) = [e for e in notes if e["name"] == "analysis_rerun"]
    assert rerun["args"]["reason"] == "open_overflow" and rerun["args"]["request"] == first
    fetches = [e["args"]["request"] for e in notes if e["name"] == "analysis_fetch"]
    assert sorted(fetches) == [first, first, second]


def test_collector_pass_is_a_span(profiling_on, tmp_path):
    with profiling.trace(tmp_path):
        gc.collect()
    snap = METRICS.snapshot()
    assert snap["stage_calls"]["gc"] >= 1 and snap["counters"]["gc_passes.gen2"] >= 1
    assert any(e["name"] == "gc" and e["args"]["gen"] == 2 for e in _annotations(tmp_path))


class _Counting:
    """A stand-in for ``torch.profiler.record_function`` that counts."""

    opened = 0

    def __init__(self, name, args=None):
        type(self).opened += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def test_off_path_opens_nothing(monkeypatch):
    """Profiling off: one shared no-op for every span, no collector
    hook, no record_function opened and no counter moved by a request
    and a sweep."""
    assert not profiling.enabled()
    METRICS.reset()
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    assert profiling.stage("a") is profiling.stage("b", chunk=1)
    assert profiling.stage("a") is profiling.device_stage("c", torch.device("cpu"))
    assert profiling._on_gc not in gc.callbacks
    el, co = load_xyz(DATA / "YAQHOQ.xyz")
    pt.Molecule({"elements": el, "coordinates": co}).full_analysis(device="cpu")
    _, _, decode_slab = _two_frames()
    batch.sweep_stream(el, 2, decode_slab, lambda pos, res: None, batch_size=1, device="cpu")
    gc.collect()
    assert _Counting.opened == 0
    assert METRICS.snapshot() == {"counters": {}, "stage_seconds": {}, "stage_calls": {}}
    profiling.enable()
    try:
        assert gc.callbacks.count(profiling._on_gc) == 1
        profiling.enable()
        assert gc.callbacks.count(profiling._on_gc) == 1
    finally:
        profiling.enable(False)
        METRICS.reset()
    assert profiling._on_gc not in gc.callbacks


def test_rebuild_split(profiling_on):
    """The periodic cell's rebuild books its supercell, the key
    interning, the native BFS (a call a molecule found) and the
    assembly."""
    system = pt.MolecularSystem.load_file(DATA / "system_periodic.pdb")
    system.make_modular(rebuild=True)
    calls = METRICS.snapshot()["stage_calls"]
    assert calls["rebuild_supercell"] == 1
    assert calls["rebuild_intern"] == 2  # the supercell's keys, the native core's
    assert calls["rebuild_bfs"] == calls["rebuild_assemble"] >= len(system.molecules)
    assert calls["load_file"] == 1


def test_distributed_without_a_group_books_its_waits(profiling_on, monkeypatch):
    _fake_pipeline(monkeypatch)
    traj = pt.DLPOLY(HISTORY)
    distributed.analysis_batched_distributed(traj, frames=[0, 1], device="cpu", **FF)
    calls = METRICS.snapshot()["stage_calls"]
    for name in ("analysis_batched_distributed", "rank_barrier", "rank_pin",
                 "sweep_max_diameters"):
        assert calls[name] == 1, name


#: (metric, span it reads, unit of the readings, scale)
READERS = [
    ("sweep.open_ms_per_kframe", "sweep_open", "frames", 1e6),
    ("sweep.retry_ms_per_kframe", "sweep_retry", "frames", 1e6),
    ("single.enqueue_ms_per_structure", "analysis_enqueue", "structures", 1e3),
    ("single.fetch_wait_ms_per_structure", "analysis_fetch", "structures", 1e3),
    ("single.rerun_ms_per_structure", "analysis_rerun", "structures", 1e3),
    ("single.load_file_ms_per_structure", "load_file", "structures", 1e3),
    ("periodic.rebuild_bfs_ms_per_frame", "rebuild_bfs", "frames", 1e3),
    ("ranks.barrier_ms_per_kframe", "rank_barrier", "frames", 1e6),
]


@pytest.mark.parametrize("metric,span,unit,scale", READERS, ids=[r[0] for r in READERS])
def test_reader(metric, span, unit, scale):
    """Each new reader: its span's seconds per unit; 0.0 for a re-run
    span that never opened where the program spans its passes; nothing
    where the program has none of these spans (the parent's)."""
    from portbench import run

    read = run.reader(metric)
    units = {"frames": 21600, "structures": 250}
    ours = {"sweep_open": 0.1, "analysis_enqueue": 0.4, "sweep_dispatch": 0.2}
    assert read({"spans": {**ours, span: 0.25}, "span_units": units}) == pytest.approx(
        0.25 * scale / units[unit]
    )
    without = read({"spans": ours, "span_units": units})
    if span in ("sweep_retry", "analysis_rerun"):
        assert without == 0.0
    elif span not in ours:
        assert without is None
    assert read({"spans": {"sweep_dispatch": 0.2}, "span_units": units}) is None
    assert read({"span_units": units}) is None
