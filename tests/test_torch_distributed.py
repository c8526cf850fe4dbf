"""The multi-process sweep of pywindow_torch (``parallel/distributed.py``)
on the CPU: real ``gloo`` process groups of localhost subprocesses.

- ``_shard_frames`` against the JAX package's over the cases of
  tests/test_distributed.py, with its coverage property.
- 2 ranks over the 20 frames of ``HISTORY_singlemol_short`` and 3 ranks
  over its first 17: every rank holds every frame exactly once, the
  ranks hold equal dicts, and they equal the port's single-process
  ``analysis_batched(device="cpu")`` over the same frames, every value
  bit for bit, and the JAX package's ``analysis_batched`` over the same
  frames, on its parity frames, within 1e-8 Å where no optimiser runs
  and 1e-4 Å for optimised values (tests/test_torch_batch.py's
  tolerances).
- The gathered rows of another rank convert to the dicts that rank's
  sweep delivered, re-run frames included, bit for bit.
- 2 ranks over frames whose second half, scaled by 1.35, grows the
  sampling sizes: both ranks run the sweep-wide sizes (the first rank's
  own frames would give smaller ones), equal to the single-process
  sweep, which restarts mid-stream, bit for bit.
- A world size of 1, without ``initialize``, is the local path.

The worker imports ``pywindow_torch`` only (no test module, since
tests/conftest.py imports JAX) and asserts that JAX never loaded; each
subprocess fails its test when it runs past :data:`TIMEOUT` seconds.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import pywindow_torch as pt
from pywindow_torch.ops.analysis import max_dim_host, static_sizes
import pywindow_tpu as pw
from pywindow_torch.config import DEFAULT_CONFIG
from pywindow_torch.parallel import batch, distributed
from pywindow_tpu.parallel.distributed import _shard_frames as jax_shard_frames
from tests.conftest import DATA
from tests.test_torch_batch import _assert_props_close
from tests.test_torch_stream import _assert_identical, _escalating, _xyz

HISTORY = DATA / "HISTORY_singlemol_short"
#: frames on which both packages' float64 drivers stop at the same kink
#: (tests/test_torch_batch.py)
PARITY_FRAMES = [2, 4, 10, 15, 19]
FF = {"swap_atoms": {"he": "H"}, "forcefield": "OPLS"}
ROOT = pathlib.Path(__file__).resolve().parent.parent
#: seconds a rank may take before its test fails
TIMEOUT = 300

WORKER = r"""
import pickle, sys, time
import torch
import pywindow_torch as pt
from pywindow_torch.parallel import distributed, mesh

rank, world, port, path, out, frames = sys.argv[1:7]
dev = distributed.initialize(f"127.0.0.1:{port}", int(world), int(rank))
assert dev == torch.device("cpu"), dev
traj = (pt.XYZ if path.endswith(".xyz") else pt.DLPOLY)(path)
t0 = time.perf_counter()
plan = distributed.analysis_batched_distributed(
    traj, frames="all" if frames == "all" else list(range(int(frames))),
    swap_atoms={"he": "H"}, forcefield="OPLS", device="cpu",
)
seconds = time.perf_counter() - t0
bad = [m for m in ("jax", "pywindow_tpu") if m in sys.modules]
assert not bad, bad
with open(out, "wb") as fh:
    pickle.dump(
        {"output": traj.analysis_output, "plan": plan, "seconds": seconds,
         "ranks_on": mesh.ranks_on(torch.device("cpu"))},
        fh,
    )
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize(
    ("n_frames", "n_procs"),
    [(20, 2), (20, 3), (17, 3), (5, 4), (2, 3), (1, 2)],
)
def test_shard_frames_matches_jax_and_covers_exactly(n_frames, n_procs):
    """The JAX package's shards; contiguous, equal-size (padded by
    repetition), and together every frame exactly once after the
    collector's de-duplication (skip k when it repeats k - 1)."""
    todo = list(range(n_frames))
    shards = distributed._shard_frames(todo, n_procs)
    assert shards == jax_shard_frames(todo, n_procs)
    per = len(shards[0])
    assert all(len(s) == per for s in shards)
    for shard in shards:
        uniq = sorted(set(shard))
        assert uniq == list(range(uniq[0], uniq[-1] + 1))
        for k in range(1, len(shard)):
            assert shard[k] in (shard[k - 1], shard[k - 1] + 1)
    collected = [f for s in shards for k, f in enumerate(s) if k == 0 or s[k] != s[k - 1]]
    assert sorted(set(collected)) == todo
    # only shards made of padding alone re-deliver a frame
    assert len(collected) - len(set(collected)) == n_procs - -(-n_frames // per)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, n_procs: int, path, frames: str) -> list[dict]:
    """Start ``n_procs`` gloo ranks over ``path``; each one's pickled
    report.  A rank that fails or runs past TIMEOUT fails the test."""
    port = _free_port()
    outs = [tmp_path / f"rank_{p}.pkl" for p in range(n_procs)]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(p), str(n_procs), str(port), str(path), str(outs[p]), frames],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for p in range(n_procs)
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
    reports = []
    for out in outs:
        with out.open("rb") as fh:
            reports.append(pickle.load(fh))
    return reports


def _assert_frames_equal(got: dict, ref: dict) -> None:
    """Every frame's dict equal to the reference's, value for value;
    a difference names its frame and key."""
    assert sorted(got) == sorted(ref)
    for f in ref:
        assert sorted(got[f]) == ["0"], f
        try:
            _assert_identical(got[f]["0"], ref[f]["0"])
        except AssertionError as exc:
            raise AssertionError(f"frame {f}: {exc}") from exc


@pytest.mark.parametrize(("n_procs", "frames", "expected"), [(2, "all", 20), (3, "17", 17)])
def test_ranks_equal_the_single_process_sweep(tmp_path, n_procs, frames, expected):
    """2 ranks over 20 frames (10 + 10) and 3 ranks over 17 (6 + 6 +
    5 and a repeat): every rank holds every frame once, the ranks are
    equal, and they equal the single-process sweep bit for bit and the
    JAX package's sweep on the parity frames within 1e-8 / 1e-4 Å."""
    reports = _run_ranks(tmp_path, n_procs, HISTORY, frames)
    for r in reports:
        assert sorted(r["output"]) == list(range(expected))
        assert r["ranks_on"] == n_procs  # every rank on this host's CPU
        assert r["plan"] == reports[0]["plan"]
    for r in reports[1:]:
        _assert_frames_equal(r["output"], reports[0]["output"])
    single = pt.DLPOLY(HISTORY)
    single.analysis_batched(frames=list(range(expected)), device="cpu", **FF)
    _assert_frames_equal(reports[0]["output"], single.analysis_output)
    # the JAX sweep over the same frames (the pin is their largest
    # maximum diameter), compared on the frames where both packages'
    # float64 drivers agree
    jtraj = pw.DLPOLY(HISTORY)
    jtraj.analysis_batched(frames=list(range(expected)), **FF)
    for f in [f for f in PARITY_FRAMES if f < expected]:
        got, ref = reports[0]["output"][f]["0"], jtraj.analysis_output[f]["0"]
        assert got["no_of_atoms"] == ref["no_of_atoms"] == 168
        _assert_props_close(got, ref)


def test_ranks_take_the_sweep_wide_sizes(tmp_path):
    """Frames 2, 4, 7, 9 and the same four scaled by 1.35: rank 0's own
    frames give smaller sampling sizes than rank 1's.  Both ranks run the
    sizes of the largest maximum diameter of all eight (the all-reduced
    pin), and equal the single-process sweep, which restarts when its
    second slab grows the sizes, bit for bit."""
    elements, coords, maxd = _escalating()
    path = _xyz(tmp_path / "grow.xyz", coords)
    reports = _run_ranks(tmp_path, 2, path, "all")
    # the pin as the ranks decode it: the file's coordinates, not the
    # fixture's, so each frame's maximum diameter is read back from it
    frames = pt.XYZ(path).get_frames(list(range(8)), **FF)
    read = [max_dim_host(elements, m.system["coordinates"]) for m in frames.values()]
    assert np.allclose(read, maxd, atol=1e-6)
    own = static_sizes(max(read[:4]), DEFAULT_CONFIG)
    swept = static_sizes(max(read), DEFAULT_CONFIG)
    assert own != swept
    for r in reports:
        pin, sizes = r["plan"]
        assert sizes == swept
        assert pin == pytest.approx(max(read), abs=1e-9)
    _assert_frames_equal(reports[1]["output"], reports[0]["output"])
    single = pt.XYZ(path)
    single.analysis_batched(batch_size=4, device="cpu", **FF)
    _assert_frames_equal(reports[0]["output"], single.analysis_output)


@pytest.mark.parametrize("max_windows", [DEFAULT_CONFIG.max_windows, 2])
def test_gathered_rows_convert_to_the_ranks_dicts(max_windows):
    """What a rank rebuilds from another rank's gathered rows and re-run
    dicts equals the dicts that rank's sweep delivered, bit for bit: with
    the default caps, and with two window slots, where every frame
    saturates them and is re-run at four."""
    import dataclasses

    cfg = dataclasses.replace(DEFAULT_CONFIG, max_windows=max_windows)
    fr = pt.DLPOLY(HISTORY).get_frames([2, 4, 10], **FF)
    elements = np.asarray(fr[2].system["elements"])
    coords = np.stack([m.system["coordinates"] for m in fr.values()])
    maxd = batch.frame_max_diameters(elements, coords, "cpu")
    delivered: dict = {}
    block = np.empty((3, 21 + 6 * max_windows))
    redone: dict = {}

    def on_rows(positions, rows, redo):
        block[positions] = rows
        redone.update({int(positions[i]): props for i, props in redo.items()})

    batch.sweep_uniform(
        elements, coords, maxd, lambda pos, res: delivered.update(zip(pos.tolist(), res)), cfg,
        batch_size=2, device="cpu", learn_caps=False, on_rows=on_rows,
    )
    assert sorted(redone) == ([0, 1, 2] if max_windows == 2 else [])
    rebuilt = distributed._rows_to_dicts(block, cfg, redone)
    assert len(rebuilt) == 3
    for f, props in enumerate(rebuilt):
        _assert_identical(props, delivered[f])


def test_world_of_one_is_the_local_path(monkeypatch):
    """Without a process group the distributed sweep is the local one:
    the same dicts as analysis_batched, bit for bit; analysed frames are
    skipped unless override; no card means no fallback."""
    frames = [2, 4, 10, 15]
    traj = pt.DLPOLY(HISTORY)
    plan = distributed.analysis_batched_distributed(traj, frames=frames, device="cpu", **FF)
    ref = pt.DLPOLY(HISTORY)
    ref.analysis_batched(frames=frames, device="cpu", **FF)
    _assert_frames_equal(traj.analysis_output, ref.analysis_output)
    assert plan[1] == static_sizes(plan[0], DEFAULT_CONFIG)
    assert distributed.analysis_batched_distributed(traj, frames=frames, device="cpu", **FF) is None
    before = traj.analysis_output[2]
    distributed.analysis_batched_distributed(traj, frames=frames, override=True, device="cpu", **FF)
    assert traj.analysis_output[2] is not before
    _assert_frames_equal(traj.analysis_output, ref.analysis_output)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.analysis_batched_distributed(pt.DLPOLY(HISTORY), frames=frames, **FF)
