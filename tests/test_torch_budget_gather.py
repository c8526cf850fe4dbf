"""A sweep's fast-budget re-runs gathered into one batch
(``parallel.batch._sweep_frames``), on the CPU in float64.

Low fast budgets (``fast_opt_maxiter=20``, ``fast_nm_maxiter=60``) make
frames 0, 6 and 13 of ``HISTORY_singlemol_short`` stop on a budget at
the sampling sizes of frame 17; four window slots make every CC3 frame
(four windows) saturate them, so each budget frame carries both markers.

- A uniform sweep and a streamed one (``analysis_batched``) give the
  dicts of the per-chunk re-runs, every value bit for bit, with the
  same escalation counts a chunk and the same re-run counters; one
  ``sweep_rerun`` of reason ``budget`` a sweep, and
  ``frames_budget_gathered`` equals ``frames_retried.budget``.
- Each chunk delivers its final dicts only; the held-back frames come
  in one more delivery, and an autosave written mid-sweep holds no
  fast-budget dict.
- A full-budget re-run's dicts do not depend on the frames that share
  its batch, which size its ray paths.
- A streamed restart drops the frames its first pass held back.
- Two gloo ranks give the dicts of the per-chunk sweep.
"""

import dataclasses
import logging
import os
import pickle
import subprocess
import sys

import pytest
import torch

import pywindow_torch as pt
from pywindow_torch import profiling
from pywindow_torch.config import DEFAULT_CONFIG
from pywindow_torch.ops.analysis import batch_sizes, max_dim_bound
from pywindow_torch.parallel import batch
from pywindow_torch.trajectory import Trajectory
from tests.test_torch_distributed import ROOT, TIMEOUT, _free_port
from tests.test_torch_stream import FF, HISTORY, _assert_identical, _escalating, _frames

LOW = {"fast_opt_maxiter": 20, "fast_nm_maxiter": 60}
CFG = dataclasses.replace(DEFAULT_CONFIG, max_windows=4, **LOW)
#: frame 17 sets the sampling sizes (first, so that the streamed sweep
#: never restarts); 0, 6 and 13 stop on a fast budget
FRAMES = [17, 0, 6, 13]
BUDGET = [1, 2, 3]  # their positions
CHUNK = 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def frames():
    elements, coords = _frames(FRAMES)
    return elements, coords, batch.frame_max_diameters(elements, coords, "cpu")


def _per_chunk(monkeypatch) -> None:
    """Each chunk re-runs its own fast-budget frames, as the sweep did
    before it gathered them: the retry never defers."""
    retry = batch.retry_saturated_windows

    def per_chunk(*args, defer_budget=None, **kwargs):
        return retry(*args, **kwargs)

    monkeypatch.setattr(batch, "retry_saturated_windows", per_chunk)


def _watched(run) -> dict:
    """``run(on_batch)`` with profiling on: the dicts, each delivery's
    positions, each chunk's escalation counts, the ``sweep_rerun``
    reasons asked for and the counters."""
    out = {"dicts": {}, "deliveries": [], "sinks": [], "reruns": []}
    stage, retry = batch.stage, batch.retry_saturated_windows

    def spy_stage(name, **ids):
        if name == "sweep_rerun":
            out["reruns"].append(ids["reason"])
        return stage(name, **ids)

    def spy_retry(*args, escalation_sink=None, **kwargs):
        got = retry(*args, escalation_sink=escalation_sink, **kwargs)
        if escalation_sink is not None:
            out["sinks"].append({k: v for k, v in escalation_sink.items() if k != "redone"})
        return got

    def on_batch(positions, results):
        out["deliveries"].append(positions.tolist())
        out["dicts"].update(zip(positions.tolist(), results))

    batch.LEARNED_CAPS._caps.clear()
    profiling.METRICS.reset()
    profiling.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(batch, "stage", spy_stage)
            mp.setattr(batch, "retry_saturated_windows", spy_retry)
            run(on_batch)
    finally:
        profiling.enable(False)
        batch.LEARNED_CAPS._caps.clear()
    out["counters"] = profiling.METRICS.snapshot()["counters"]
    profiling.METRICS.reset()
    return out


def _uniform(frames):
    elements, coords, maxd = frames
    return lambda on_batch: batch.sweep_uniform(
        elements, coords, maxd, on_batch, CFG, batch_size=CHUNK, device="cpu"
    )


@pytest.fixture(scope="module")
def reference(frames):
    with pytest.MonkeyPatch.context() as mp:
        _per_chunk(mp)
        return _watched(_uniform(frames))


@pytest.fixture(scope="module")
def gathered(frames):
    return _watched(_uniform(frames))


def _retried(counters: dict) -> dict:
    return {k: v for k, v in counters.items() if k.startswith("frames_retried.")}


def test_gathered_equals_the_per_chunk_reruns(reference, gathered):
    assert sorted(gathered["dicts"]) == sorted(reference["dicts"]) == list(range(len(FRAMES)))
    for f in reference["dicts"]:
        _assert_identical(gathered["dicts"][f], reference["dicts"][f])
    # the chunks count what they counted, and each frame re-runs for the
    # same reasons as often: a budget frame re-runs once, at the full
    # budgets, whose own retry doubles its window slots
    assert gathered["sinks"] == reference["sinks"]
    assert sum(s["budget"] for s in reference["sinks"]) == len(BUDGET)
    assert sum(s["window_sat"] for s in reference["sinks"]) == len(FRAMES) - len(BUDGET)
    assert _retried(gathered["counters"]) == _retried(reference["counters"])
    assert reference["counters"]["frames_retried.window_sat"] == len(FRAMES)


def test_one_budget_rerun_a_sweep(reference, gathered):
    assert reference["reruns"].count("budget") == 2  # one a chunk
    assert gathered["reruns"].count("budget") == 1
    counters = gathered["counters"]
    assert counters["frames_budget_gathered"] == counters["frames_retried.budget"] == len(BUDGET)
    assert "frames_budget_gathered" not in reference["counters"]


def test_held_back_frames_arrive_in_one_more_delivery(reference, gathered):
    assert reference["deliveries"] == [[0, 1], [2, 3]]
    assert gathered["deliveries"] == [[0], [], BUDGET]


def test_full_budget_rerun_does_not_depend_on_its_batch(frames):
    """Frame 0 re-run at the full budgets alone, and beside a frame
    scaled by 1.35 whose bound lengthens both ray paths: its dict is
    the same to the bit."""
    elements, coords, maxd = frames
    pin = float(maxd.max())
    full = dataclasses.replace(DEFAULT_CONFIG, fast_budgets=False)
    own, wide = coords[BUDGET[0]], coords[0] * 1.35
    short = batch_sizes(pin, max_dim_bound(elements, own), full)
    long = batch_sizes(pin, max_dim_bound(elements, wide), full)
    assert short[:2] == long[:2] and short[2] < long[2] and short[3] < long[3]
    alone = batch.analyze_batch([(elements, own)], full, reference_max_diameter=pin, device="cpu")
    shared = batch.analyze_batch(
        [(elements, wide), (elements, own)], full, reference_max_diameter=pin, device="cpu"
    )
    _assert_identical(shared[1], alone[0])


def test_streamed_sweep_and_its_autosaves(tmp_path, monkeypatch, reference):
    """``analysis_batched`` (the streamed route) at ``CFG`` with an
    autosave after every delivery: the final dicts are the per-chunk
    sweep's, and every dict a checkpoint holds is final."""
    sweep_stream = batch.sweep_stream
    monkeypatch.setattr(batch, "sweep_stream", lambda *a, **k: sweep_stream(*a, cfg=CFG, **k))
    traj = pt.DLPOLY(HISTORY)
    saves: list = []
    save = Trajectory.save_analysis

    def save_spy(self, *args, **kwargs):
        saves.append({f: v["0"] for f, v in self.analysis_output.items()})
        return save(self, *args, **kwargs)

    monkeypatch.setattr(Trajectory, "save_analysis", save_spy)
    batch.LEARNED_CAPS._caps.clear()
    traj.analysis_batched(
        frames=FRAMES, batch_size=CHUNK, autosave=tmp_path / "ckpt.json", autosave_every=1,
        device="cpu", **FF,
    )
    batch.LEARNED_CAPS._caps.clear()
    final = {f: v["0"] for f, v in traj.analysis_output.items()}
    assert sorted(final) == sorted(FRAMES)
    for pos, f in enumerate(FRAMES):
        ref = dict(reference["dicts"][pos])
        ref.pop("molecular_weight")
        _assert_identical(final[f], {**ref, "no_of_atoms": 168})
    # mid-sweep checkpoints lack the held-back frames, never hold them
    # at their fast budgets
    held = {FRAMES[p] for p in BUDGET}
    assert any(snap and not held & set(snap) for snap in saves[:-1])
    for snap in saves:
        for f, props in snap.items():
            assert props is final[f]


def test_restart_drops_the_held_back_frames(caplog):
    """At budgets of 10 and 30 every frame of the escalating set stops
    on them: the first pass holds back its chunk's four, the restart
    drops them, and the final pass re-runs its eight in one batch."""
    elements, coords, maxd = _escalating()
    cfg = dataclasses.replace(DEFAULT_CONFIG, fast_opt_maxiter=10, fast_nm_maxiter=30)

    def decode_slab(lo, hi, out64=None, out32=None):
        out64[...] = coords[lo:hi]
        return maxd[lo:hi]

    with caplog.at_level(logging.INFO, logger="pywindow_torch"):
        got = _watched(
            lambda on_batch: batch.sweep_stream(
                elements, len(coords), decode_slab, on_batch, cfg, batch_size=4, device="cpu"
            )
        )
    counters = got["counters"]
    assert counters["sweep_restarts"] == 1
    assert [s["budget"] for s in got["sinks"]] == [4, 4, 4]  # the first pass's chunk, then two
    assert got["reruns"].count("budget") == 1
    assert counters["frames_budget_gathered"] == counters["frames_retried.budget"] == 8
    assert got["deliveries"][-1] == list(range(8))
    assert sorted(got["dicts"]) == list(range(8))


WORKER = r"""
import dataclasses, pickle, sys
import torch
import pywindow_torch as pt
from pywindow_torch.config import DEFAULT_CONFIG
from pywindow_torch.parallel import distributed

rank, world, port, path, out = sys.argv[1:6]
distributed.initialize(f"127.0.0.1:{port}", int(world), int(rank))
traj = pt.DLPOLY(path)
cfg = dataclasses.replace(DEFAULT_CONFIG, max_windows=4, fast_opt_maxiter=20, fast_nm_maxiter=60)
distributed.analysis_batched_distributed(
    traj, frames=[17, 0], swap_atoms={"he": "H"}, forcefield="OPLS", cfg=cfg,
    device="cpu",
)
assert "jax" not in sys.modules
with open(out, "wb") as fh:
    pickle.dump(traj.analysis_output, fh)
torch.distributed.destroy_process_group()
"""


def test_two_ranks_equal_the_per_chunk_sweep(tmp_path, reference):
    """Two gloo ranks over frames 17 and 0 (the second rank's frame
    stops on a budget, both sweep at frame 17's sizes): both ranks hold
    both frames, with the per-chunk sweep's dicts bit for bit."""
    port = _free_port()
    outs = [tmp_path / f"rank_{p}.pkl" for p in range(2)]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(p), "2", str(port), str(HISTORY), str(outs[p])],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for p in range(2)
    ]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for p, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {p}:\n{log[-4000:]}"
    for out in outs:
        with out.open("rb") as fh:
            output = pickle.load(fh)
        assert sorted(output) == [0, 17]
        for f in output:
            ref = dict(reference["dicts"][FRAMES.index(f)])
            ref.pop("molecular_weight")
            _assert_identical(output[f]["0"], {**ref, "no_of_atoms": 168})
