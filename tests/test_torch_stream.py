"""The streamed sweep (``parallel.batch.sweep_stream``) and the route
that ``analysis_batched`` takes by default, on the CPU in float64.

- The stream against the port's ``sweep_uniform`` on the same frames:
  bit for bit (every value of every dict equal), also across a
  mid-stream escalation of the sampling sizes, with the ``size_gate``
  log of each delivery.
- ``DLPOLY(...).analysis_batched(device="cpu")`` against the JAX
  package's at the tolerances of tests/test_torch_batch.py (1e-8 Å
  where no optimiser runs, 1e-4 Å for optimised centres and windows).
- A slab whose atom ids diverge sends the frames to the generic path.
- No autosave is written before an escalation restart.
"""

import logging

import numpy as np
import pytest

import pywindow_torch as pt
import pywindow_tpu as pw
from pywindow_torch import native
from pywindow_torch.config import DEFAULT_CONFIG
from pywindow_torch.ops.analysis import max_dim_host, static_sizes
from pywindow_torch.parallel import batch
from pywindow_torch.trajectory import Trajectory
from tests.conftest import DATA

HISTORY = DATA / "HISTORY_singlemol_short"
FF = {"swap_atoms": {"he": "H"}, "forcefield": "OPLS"}
EXACT = 1e-8
OPTIMISED = 1e-4


def _frames(idx):
    fr = pt.DLPOLY(HISTORY).get_frames(idx, **FF)
    elements = fr[idx[0]].system["elements"]
    return np.asarray(elements), np.stack([m.system["coordinates"] for m in fr.values()])


#: the fixture's force-field atom ids (frame 0's; every frame has them)
IDS = list(pt.DLPOLY(HISTORY)._raw_frames([0])[0]["atom_ids"])


def _escalating():
    """Frames 2, 4, 7, 9 and the same four scaled by 1.35 about the
    origin: the second half's maximum diameter changes the discrete
    sampling sizes."""
    elements, coords = _frames([2, 4, 7, 9])
    coords = np.concatenate([coords, coords * 1.35])
    maxd = np.array([max_dim_host(elements, c) for c in coords])
    assert static_sizes(float(maxd[:4].max()), DEFAULT_CONFIG) != static_sizes(
        float(maxd.max()), DEFAULT_CONFIG
    )
    return elements, coords, maxd


def _assert_identical(a: dict, b: dict) -> None:
    """Every value of two properties dicts equal, bit for bit."""
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            assert sorted(x) == sorted(y)
            for sub in x:
                if x[sub] is None:
                    assert y[sub] is None, (key, sub)
                else:
                    np.testing.assert_array_equal(x[sub], y[sub], err_msg=f"{key}.{sub}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=key)


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


def _run_uniform(elements, coords, maxd, batch_size):
    got: dict = {}
    batch.LEARNED_CAPS._caps.clear()
    batch.sweep_uniform(
        elements, coords, maxd, lambda pos, res: got.update(zip(pos.tolist(), res)),
        batch_size=batch_size, device="cpu",
    )
    return got


def _run_stream(elements, coords, maxd, batch_size, gate_log=None):
    got: dict = {}
    gate: dict = {"final": False}

    def decode_slab(lo, hi, out64=None, out32=None):
        for out in (out64, out32):
            if out is not None:
                out[...] = coords[lo:hi]
        return maxd[lo:hi]

    def on_batch(pos, res):
        got.update(zip(pos.tolist(), res))
        if gate_log is not None:
            gate_log.append(bool(gate["final"]))

    batch.LEARNED_CAPS._caps.clear()
    batch.sweep_stream(
        elements, len(coords), decode_slab, on_batch, batch_size=batch_size,
        size_gate=gate, device="cpu",
    )
    return got


def test_stream_equals_uniform_bit_for_bit():
    """Six frames in chunks of four (the last one of two frames, run at
    its own size): the stream's dicts equal sweep_uniform's to the bit,
    and both equal one chunk of all six frames to the bit."""
    elements, coords = _frames([2, 4, 7, 9, 10, 11])
    maxd = np.array([max_dim_host(elements, c) for c in coords])
    uniform = _run_uniform(elements, coords, maxd, 4)
    stream = _run_stream(elements, coords, maxd, 4)
    whole = _run_uniform(elements, coords, maxd, 6)
    assert sorted(stream) == sorted(uniform) == sorted(whole) == list(range(6))
    for f in uniform:
        _assert_identical(stream[f], uniform[f])
        _assert_identical(whole[f], uniform[f])


def test_stream_escalation_equals_uniform(caplog):
    """The second slab escalates the sampling sizes: the stream restarts
    over the decoded frames and its final dicts equal sweep_uniform's to
    the bit; the delivery before the restart is flagged not final, the
    final pass final."""
    elements, coords, maxd = _escalating()
    uniform = _run_uniform(elements, coords, maxd, 4)
    gate_log: list = []
    with caplog.at_level(logging.INFO, logger="pywindow_torch"):
        stream = _run_stream(elements, coords, maxd, 4, gate_log)
    assert any("escalated mid-stream" in r.message for r in caplog.records)
    assert gate_log == [False, True, True]
    assert sorted(stream) == sorted(uniform) == list(range(8))
    for f in uniform:
        _assert_identical(stream[f], uniform[f])


def test_analysis_batched_streams_and_matches_jax(monkeypatch):
    """DLPOLY.analysis_batched takes the streamed route by default (the
    native slab decoder and sweep_stream) and matches the JAX package."""
    frames = [2, 4, 7, 9]
    streamed = []
    sweep_stream = batch.sweep_stream

    def spy(*args, **kwargs):
        streamed.append(args[1])
        return sweep_stream(*args, **kwargs)

    monkeypatch.setattr(batch, "sweep_stream", spy)
    calls = native.CALLS["decode_dlpoly_frames_batch"]
    traj = pt.DLPOLY(HISTORY)
    traj.analysis_batched(frames=frames, batch_size=2, device="cpu", **FF)
    assert streamed == [4]
    assert native.CALLS["decode_dlpoly_frames_batch"] == calls + 2  # two slabs
    jtraj = pw.DLPOLY(HISTORY)
    jtraj.analysis_batched(frames=frames, **FF)
    assert sorted(traj.analysis_output) == frames
    for f in frames:
        got = traj.analysis_output[f]["0"]
        assert got["no_of_atoms"] == 168 and "molecular_weight" not in got
        _close(got, jtraj.analysis_output[f]["0"])


def _xyz(path, coords, ids=None):
    """An XYZ trajectory of ``coords`` under the fixture's atom ids (or
    ``ids[f]`` for frame f)."""
    blocks = []
    for f, frame in enumerate(coords):
        names = IDS if ids is None else ids[f]
        lines = [str(len(names)), f"frame {f}"]
        lines += [f"{el} {x:.8f} {y:.8f} {z:.8f}" for el, (x, y, z) in zip(names, frame)]
        blocks.append("\n".join(lines))
    path.write_text("\n".join(blocks) + "\n")
    return path


def test_diverging_atom_ids_fall_back_to_the_generic_path(tmp_path, monkeypatch):
    """Frames 2 and 3 swap two atom ids, so the second slab (decoded on
    the decoder thread) raises SweepDecodeError: every frame then goes
    through the generic per-frame path, and frames 0 and 1 equal the
    streamed run of the same frames without the swap."""
    _, coords = _frames([2, 4, 7, 9])
    ids = [list(IDS) for _ in range(4)]
    i_c, i_n = IDS.index("ca"), IDS.index("ni")
    for f in (2, 3):
        ids[f][i_c], ids[f][i_n] = ids[f][i_n], ids[f][i_c]
    diverging = _xyz(tmp_path / "diverge.xyz", coords, ids)
    plain = _xyz(tmp_path / "plain.xyz", coords)
    generic = []
    sweep_generic = Trajectory._sweep_generic

    def spy(self, todo, *args, **kwargs):
        generic.append(list(todo))
        return sweep_generic(self, todo, *args, **kwargs)

    monkeypatch.setattr(Trajectory, "_sweep_generic", spy)
    t = pt.XYZ(diverging)
    t.analysis_batched(batch_size=2, reference_max_diameter=23.6, device="cpu", **FF)
    assert generic == [[0, 1, 2, 3]]
    assert sorted(t.analysis_output) == [0, 1, 2, 3]
    ref = pt.XYZ(plain)
    ref.analysis_batched(batch_size=2, reference_max_diameter=23.6, device="cpu", **FF)
    assert generic == [[0, 1, 2, 3]]  # the plain file streamed
    for f in range(4):
        assert t.analysis_output[f]["0"]["maximum_diameter"]["diameter"] > 0
    for f in (0, 1):
        _close(t.analysis_output[f]["0"], ref.analysis_output[f]["0"])


def test_no_autosave_before_the_escalation_restart(tmp_path, monkeypatch, caplog):
    """With autosave after every chunk, the chunk delivered before the
    escalation restart writes no checkpoint: the first save follows the
    restart, and the saved file holds the final results."""
    _, coords, _ = _escalating()
    path = _xyz(tmp_path / "grow.xyz", coords)
    events: list = []
    record = Trajectory._sweep_on_batch
    save = Trajectory.save_analysis

    def on_batch_spy(self, *args):
        inner = record(self, *args)

        def wrapped(pos, res):
            events.append("chunk")
            inner(pos, res)

        return wrapped

    def save_spy(self, *args, **kwargs):
        events.append("save")
        return save(self, *args, **kwargs)

    class Restart(logging.Handler):
        def emit(self, rec):
            if "escalated mid-stream" in rec.getMessage():
                events.append("restart")

    monkeypatch.setattr(Trajectory, "_sweep_on_batch", on_batch_spy)
    monkeypatch.setattr(Trajectory, "save_analysis", save_spy)
    handler = Restart()
    logger = logging.getLogger("pywindow_torch")
    logger.addHandler(handler)
    old_level = logger.level
    logger.setLevel(logging.INFO)
    try:
        batch.LEARNED_CAPS._caps.clear()
        t = pt.XYZ(path)
        t.analysis_batched(
            batch_size=4, autosave=tmp_path / "ckpt.json", autosave_every=1, device="cpu", **FF
        )
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    assert events[:2] == ["chunk", "restart"]
    assert events.count("restart") == 1
    assert events[2:] == ["chunk", "save", "chunk", "save", "save"]
    resumed = pt.XYZ(path)
    resumed.load_analysis(tmp_path / "ckpt.json")
    assert sorted(resumed.analysis_output) == list(range(8))
    for f in range(8):
        assert resumed.analysis_output[f]["0"]["average_diameter"] == pytest.approx(
            t.analysis_output[f]["0"]["average_diameter"], abs=1e-12
        )
