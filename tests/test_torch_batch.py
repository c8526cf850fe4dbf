"""The batched path and the DL_POLY sweep: pywindow_torch's
``analyze_batch`` and ``DLPOLY.analysis_batched`` against
pywindow_tpu's on the same HISTORY frames, batches against their B = 1
runs, and the host pieces of ``parallel/batch.py``.

Tolerances (float64): 1e-8 Å for everything computed without an
optimiser, 1e-4 Å for optimised centres and windows (XLA's fused
multiply-adds, amplified by the FD gradients, move a stop on a kink
ridge; see tests/test_torch_analysis.py).

The JAX comparisons use fixture frames on which the float64 classic FD
driver stops at the same kink in both packages.  On the MD frames 0, 1,
3, 5, 6, 12, 13 and 17 the two packages' drivers stop at neighbouring
kinks (the optimised centre moves by up to 0.05 Å on frame 6), and on
frame 8 the JAX package's own stop depends on its batch size: the chaos
ROADMAP Q3.4 records for NUXHIZ, which the card's stable drivers do not
have.
"""

import numpy as np
import pytest

import pywindow_torch as pt
import pywindow_tpu as pw
from pywindow_torch.config import DEFAULT_CONFIG, AnalysisConfig
from pywindow_torch.ops import analysis as tanalysis
from pywindow_torch.ops.ray_kernels import MAX_FRAMES
from pywindow_torch.parallel import batch
from pywindow_tpu.ops import analysis as janalysis
from pywindow_tpu.parallel import batch as jbatch
from tests.conftest import DATA, load_structure

HISTORY = DATA / "HISTORY_singlemol_short"
FF = {"swap_atoms": {"he": "H"}, "forcefield": "OPLS"}
EXACT = 1e-8
OPTIMISED = 1e-4


def _frames(idx):
    traj = pt.DLPOLY(HISTORY)
    fr = traj.get_frames(idx, **FF)
    return [(m.system["elements"], m.system["coordinates"]) for m in fr.values()]


def _assert_props_close(got, ref):
    for key in ("average_diameter", "pore_volume"):
        assert got[key] == pytest.approx(ref[key], abs=EXACT)
    for key in ("maximum_diameter", "pore_diameter"):
        assert got[key]["diameter"] == pytest.approx(ref[key]["diameter"], abs=EXACT)
    np.testing.assert_allclose(got["centre_of_mass"], ref["centre_of_mass"], atol=EXACT, rtol=0)
    opt, ref_opt = got["pore_diameter_opt"], ref["pore_diameter_opt"]
    assert opt["diameter"] == pytest.approx(ref_opt["diameter"], abs=OPTIMISED)
    np.testing.assert_allclose(
        opt["centre_of_mass"], ref_opt["centre_of_mass"], atol=OPTIMISED, rtol=0
    )
    gw, rw = got["windows"]["diameters"], ref["windows"]["diameters"]
    assert (gw is None) == (rw is None)
    if gw is not None:
        assert len(gw) == len(rw)
        np.testing.assert_allclose(np.sort(gw), np.sort(rw), atol=OPTIMISED, rtol=0)


def test_analyze_batch_matches_jax():
    systems = _frames([2, 10, 19])
    got = batch.analyze_batch(systems, device="cpu")
    ref = jbatch.analyze_batch(systems)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _assert_props_close(g, r)
        assert g["molecular_weight"] == pytest.approx(r["molecular_weight"], abs=EXACT)


def test_dlpoly_analysis_batched_matches_jax():
    frames = [10, 11, 15, 19]
    traj = pt.DLPOLY(HISTORY)
    traj.analysis_batched(frames=frames, device="cpu", **FF)
    jtraj = pw.DLPOLY(HISTORY)
    jtraj.analysis_batched(frames=frames, **FF)
    assert sorted(traj.analysis_output) == frames
    for f in frames:
        got, ref = traj.analysis_output[f]["0"], jtraj.analysis_output[f]["0"]
        assert got["no_of_atoms"] == ref["no_of_atoms"] == 168
        assert "molecular_weight" not in got
        _assert_props_close(got, ref)
    # resume semantics: analysed frames are skipped, override re-runs
    before = traj.analysis_output[10]
    traj.analysis_batched(frames=[10], device="cpu", **FF)
    assert traj.analysis_output[10] is before
    traj.analysis_batched(frames=[10], override=True, device="cpu", **FF)
    assert traj.analysis_output[10] is not before


def test_batch_of_three_equals_three_single_runs():
    """A B = 3 batch and three B = 1 batches with the same sampling pin
    give the same results: the lanes of every stage run independently."""
    systems = _frames([4, 9, 13])
    pin = 23.2
    together = batch.analyze_batch(systems, reference_max_diameter=pin, device="cpu")
    for system, got in zip(systems, together):
        alone = batch.analyze_batch([system], reference_max_diameter=pin, device="cpu")[0]
        _assert_props_close(got, alone)


def test_sweep_in_chunks_equals_one_batch():
    """sweep_uniform over three frames in chunks of two (the last one
    short) equals one analyze_batch of the three at the same pin."""
    systems = _frames([0, 10, 19])
    elements = systems[0][0]
    coords = np.stack([c for _, c in systems])
    maxd = batch.frame_max_diameters(elements, coords, "cpu")
    for (e, c), m in zip(systems, maxd):
        assert m == pytest.approx(tanalysis.max_dim_host(e, c), abs=1e-9)
    seen = {}

    def on_batch(positions, results):
        for p, r in zip(positions.tolist(), results):
            seen[p] = r

    batch.sweep_uniform(elements, coords, maxd, on_batch, batch_size=2, device="cpu")
    ref = batch.analyze_batch(systems, reference_max_diameter=float(maxd.max()), device="cpu")
    assert sorted(seen) == [0, 1, 2]
    for p in range(3):
        _assert_props_close(seen[p], ref[p])


def test_mixed_atom_ids_take_the_generic_path(tmp_path):
    """Frames whose atom ids differ (here one 'ca' relabelled 'cb', the
    same element) go through analyze_batch one system per frame and give
    the results of the uniform sweep."""
    lines = HISTORY.read_text().splitlines()
    starts = [i for i, ln in enumerate(lines) if ln.startswith("timestep")]
    first_ca = next(i for i in range(starts[1], starts[2]) if lines[i].startswith("ca "))
    lines[first_ca] = "cb" + lines[first_ca][2:]
    mixed = tmp_path / "HISTORY_mixed_ids"
    mixed.write_text("\n".join(lines) + "\n")
    uniform, generic = pt.DLPOLY(HISTORY), pt.DLPOLY(mixed)
    uniform.analysis_batched(frames=[0, 1], device="cpu", **FF)
    generic.analysis_batched(frames=[0, 1], device="cpu", **FF)
    for f in (0, 1):
        _assert_props_close(generic.analysis_output[f]["0"], uniform.analysis_output[f]["0"])


def test_properties_dicts_bulk_matches_jax():
    """The Python bulk converter against the JAX package's on a packed
    block with every marker and window state."""
    rng = np.random.default_rng(1)
    w = 4
    flat = rng.normal(size=(5, 21 + 6 * w)) + 5.0
    flat[:, 7:11] = rng.integers(0, 100, (5, 4))
    flat[:, 11] = [1, 0, 1, 1, 1]  # any_open
    flat[:, 12] = [2, 0, 4, 1, 3]  # n_clusters (4 saturates)
    flat[:, 13] = [0, 0, 1, 0, 0]  # open overflow
    flat[:, 14] = [0, 0, 0, 1, 0]  # budget
    flat[:, 21 + w : 21 + 2 * w] = rng.random((5, w)) > 0.4
    flat[:, 21 + 2 * w : 21 + 3 * w] = 0.0
    got = tanalysis.to_properties_dicts_bulk(flat, w)
    ref = janalysis.to_properties_dicts_bulk(flat, w)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for key in g:
            if key == "windows":
                for sub in ("diameters", "centre_of_mass"):
                    if r[key][sub] is None:
                        assert g[key][sub] is None
                    else:
                        np.testing.assert_array_equal(g[key][sub], r[key][sub])
            elif isinstance(g[key], dict):
                for sub in g[key]:
                    np.testing.assert_array_equal(g[key][sub], r[key][sub])
            else:
                np.testing.assert_array_equal(g[key], r[key])


def test_trajectory_integrity_errors_raise_at_construction(tmp_path):
    lines = HISTORY.read_text().splitlines()
    starts = [i for i, ln in enumerate(lines) if ln.startswith("timestep")]
    empty = tmp_path / "HISTORY_empty_line"
    empty.write_text("\n".join(lines[: starts[1]] + [""] + lines[starts[1] :]) + "\n")
    with pytest.raises(pt.trajectory.TrajectoryError, match="empty line"):
        pt.DLPOLY(empty)
    swapped = lines[: starts[1]] + lines[starts[2] : starts[3]] + lines[starts[1] : starts[2]]
    backwards = tmp_path / "HISTORY_backwards"
    backwards.write_text("\n".join(swapped) + "\n")
    with pytest.raises(pt.trajectory.TrajectoryError, match="discontinuous"):
        pt.DLPOLY(backwards)
    # the Python map and integrity check raise the same errors
    for bad, match in ((empty, "empty line"), (backwards, "discontinuous")):
        with pytest.raises(pt.trajectory.TrajectoryError, match=match):
            pt.DLPOLY(bad, use_native=False)
    traj = pt.DLPOLY(HISTORY)
    assert traj.no_of_frames == 20 and traj.no_of_atoms == 168


def test_learned_caps_evict_the_oldest_entry_only():
    caps = batch.LearnedCaps(limit=3)
    for k in range(4):
        caps.put(k, AnalysisConfig(max_windows=8 * (k + 1)))
    assert len(caps) == 3
    assert caps.get(0, DEFAULT_CONFIG) is DEFAULT_CONFIG
    assert [caps.get(k, DEFAULT_CONFIG).max_windows for k in (1, 2, 3)] == [16, 24, 32]


def test_memory_model_and_chunk_plan():
    elements, coords = load_structure("PUDXES")
    maxd = tanalysis.max_dim_host(elements, coords)
    small = batch.max_safe_batch(len(elements), maxd, device="cpu", budget=10**8)
    large = batch.max_safe_batch(len(elements), maxd, device="cpu", budget=10**10)
    assert 1 <= small < large
    assert batch.max_safe_batch(len(elements), maxd, device="cpu", budget=1) == 1
    # one ray-kernel launch takes at most MAX_FRAMES frames (grid y limit)
    huge = batch.max_safe_batch(len(elements), maxd, device="cpu", budget=10**15)
    assert huge == MAX_FRAMES
    assert batch.chunk_plan(5, 2) == [(0, 2), (2, 4), (4, 5)]
    assert batch.chunk_plan(4, 4) == [(0, 4)]
