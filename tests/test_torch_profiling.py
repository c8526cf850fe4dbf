"""``pywindow_torch.profiling``: off by default (``stage`` records
nothing), ``enable`` / ``enabled`` and ``PYWINDOW_TORCH_PROFILE=1``,
``Metrics.snapshot`` / ``reset``, the device spans (host spans on the
CPU), the sweep's stages, and ``trace`` writing a Chrome trace with the
CPU's activities."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pywindow_torch import profiling
from pywindow_torch.parallel import batch
from pywindow_torch.profiling import METRICS
from tests.conftest import DATA, load_xyz

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def profiling_on():
    saved = profiling.enabled()
    profiling.enable()
    METRICS.reset()
    yield
    profiling.enable(saved)
    METRICS.reset()


def test_stage_is_off_by_default():
    assert not profiling.enabled()
    METRICS.reset()
    with profiling.stage("idle"):
        pass
    with profiling.device_stage("idle_device", torch.device("cpu")) as span:
        pass
    span.settle()
    assert METRICS.snapshot() == {"counters": {}, "stage_seconds": {}, "stage_calls": {}}


def test_enable_snapshot_reset(profiling_on):
    with profiling.stage("a"):
        pass
    with profiling.stage("a"):
        pass
    with profiling.device_stage("b", torch.device("cpu")) as span:
        torch.ones(8).sum()
    span.settle()
    METRICS.count("frames", 3)
    snap = METRICS.snapshot()
    assert snap["stage_calls"] == {"a": 2, "b": 1}
    assert snap["stage_seconds"]["a"] >= 0.0 and snap["stage_seconds"]["b"] >= 0.0
    assert snap["counters"] == {"frames": 3}
    snap["counters"]["frames"] = 99  # a copy
    assert METRICS.counters["frames"] == 3
    METRICS.reset()
    assert METRICS.snapshot() == {"counters": {}, "stage_seconds": {}, "stage_calls": {}}
    profiling.enable(False)
    assert not profiling.enabled()


def test_environment_switch():
    code = "from pywindow_torch import profiling; print(profiling.enabled())"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for value, want in (("1", "True"), ("", "False")):
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
            env={**env, "PYWINDOW_TORCH_PROFILE": value}, timeout=300,
        )
        assert proc.stdout.strip() == want, proc.stderr


def test_sweep_stages_when_on(profiling_on):
    """Two frames through sweep_stream: decode, copy, dispatch, step,
    fetch, dicts and on_batch each recorded once per chunk."""
    el, co = load_xyz(DATA / "YAQHOQ.xyz")
    coords = np.stack([co, co + 0.01])

    def decode_slab(lo, hi, out64=None, out32=None):
        (out64 if out64 is not None else out32)[...] = coords[lo:hi]
        return np.full(hi - lo, 10.6)

    batch.sweep_stream(el, 2, decode_slab, lambda pos, res: None, batch_size=1, device="cpu")
    calls = METRICS.snapshot()["stage_calls"]
    for name in ("sweep_h2d", "sweep_dispatch", "sweep_step", "sweep_fetch", "sweep_to_dicts",
                 "sweep_on_batch"):
        assert calls[name] == 2, name
    assert calls["sweep_decode"] == 2
    assert METRICS.counters["molecules_analysed"] == 2


def test_sharded_sweep_books_one_device_span_a_chunk(profiling_on):
    """Two frames in one chunk over two shards: the shards' enqueues are
    timed each, the chunk's device time is one span (the shards on one
    device add up), as the generic path's batch is."""
    el, co = load_xyz(DATA / "YAQHOQ.xyz")
    coords = np.stack([co, co + 0.01])

    def decode_slab(lo, hi, out64=None, out32=None):
        (out64 if out64 is not None else out32)[...] = coords[lo:hi]
        return np.full(hi - lo, 10.6)

    batch.sweep_stream(el, 2, decode_slab, lambda pos, res: None, batch_size=2, device=["cpu", "cpu"])
    calls = METRICS.snapshot()["stage_calls"]
    assert calls["sweep_dispatch"] == 2
    assert calls["sweep_step"] == 1
    METRICS.reset()
    handle = batch.dispatch_batch([(el, c) for c in coords], device=["cpu", "cpu"], span="sweep_step")
    batch.collect_batch(handle)
    assert METRICS.snapshot()["stage_calls"]["sweep_step"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "tr"):
        torch.cdist(torch.ones(64, 3), torch.zeros(32, 3)).amin(-1)
    files = list((tmp_path / "tr").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("cdist" in n for n in names)
    assert any(e.get("cat") == "cpu_op" for e in events)
