"""MIBQAR (424 atoms: Zn4O nodes, DL_F keys) swept as a DL_POLY
trajectory on the CPU in float64, through ``DLPOLY(...).analysis_batched``.

Every MIBQAR frame overflows the open-ray compaction cap sized for CC3,
so the sweep re-runs each chunk's frames at a doubled cap until it
stores the doubled cap in ``LEARNED_CAPS`` (``parallel/batch.py``,
``finish``); later chunks and later sweeps open at it.

- The sweep against the JAX package's sweep of the same file, and
  against the plain reference (``portbench.reference``: the frozen
  algorithm with the compaction off and the full budgets, what the
  re-runs settle on) at the sweep's sampling sizes.
- The first sweep learns the cap from its first chunk, its last chunk
  and every frame of a second sweep dispatch at it, and both give the
  dicts of a sweep that learns nothing, to the bit.
- The ``sweep_rerun`` span (id ``reason``) and the counters
  ``caps_learned.<field>`` and ``frames_at_learned_caps`` move only
  while profiling is on.
- At the learned cap, frames that stop on a fast budget re-run in one
  gathered batch with the per-chunk re-runs' dicts, bit for bit.

The frames are ``portbench/inputs/thermal.py``'s (MIBQAR.pdb plus a
thermal displacement), the one of largest maximum diameter first, so
that the streamed sweep's sampling sizes are final from its first slab
and no restart re-dispatches its chunks.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

import pywindow_torch as pt
import pywindow_tpu as pw
from portbench.inputs import thermal
from portbench.reference import molecules, pipeline
from pywindow_torch import profiling
from pywindow_torch.config import DEFAULT_CONFIG
from pywindow_torch.ops.analysis import max_dim_host
from pywindow_torch.parallel import batch
from tests.test_torch_budget_gather import _per_chunk, _watched
from tests.test_torch_stream import _assert_identical

FRAMES = 24
FF = {"forcefield": "DLF"}
#: Å: closed forms (maximum diameter, pore at the centre of mass,
#: average diameter, centre of mass) run the same arithmetic in both
EXACT = 1e-9
#: Å: the optimised pore and the windows come from the CPU's classic
#: optimisers here and the stable ones in the reference; they stop at
#: the same minimum on most frames (medians 1e-8-1e-4 Å) ...
MEDIAN = 1e-3
#: ... and a little apart on a few, where the objective is flat: a
#: window's diameter and the optimised pore's by up to 0.016 Å, a
#: window's centre, along the window's normal, by up to 0.22 Å
DIAMETER = 0.05
CENTRE = 0.5
#: Å, against the JAX package's sweep (classic optimisers in float64 in
#: both): the optimised pore and the windows stop at neighbouring points
#: of a flat objective on a few frames, each point the objective's own
#: (the pore's diameter is the closed form at its centre).  Measured:
#: medians 9e-8-4e-5 Å; at most 0.016 Å for a diameter, 0.15 Å for a
#: window's centre, where the JAX package's serial and batched runs of
#: these frames differ by 0.10 Å and 0.78 Å
JAX_MEDIAN = 2e-4
JAX_DIAMETER = 0.03
JAX_CENTRE = 0.3
#: seconds the last slab's decode waits for the first chunk's escalation
HOLD_S = 300


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's sweeps: a chunk of 424-atom
    frames gains little from more, and in the parallel suite a worker
    shares the cores with the others, where more threads only wait."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def history(tmp_path_factory):
    """(path, elements, coordinates as written) of the 24 frames."""
    elements, coords = thermal.frames(FRAMES)
    printed = np.vectorize(lambda v: float(f"{v:12.4E}"))(coords)
    maxd = np.array([max_dim_host(elements, c) for c in printed])
    first = int(np.argmax(maxd))
    order = [first, *(k for k in range(FRAMES) if k != first)]
    path = tmp_path_factory.mktemp("mibqar") / "HISTORY"
    path.write_text(thermal.text(elements, printed[order]))
    return path, elements, printed[order]


def _sweep(path, batch_size: int) -> tuple[dict, dict, list, list]:
    """One sweep: (frame -> dict, ``METRICS.snapshot()`` over it, each
    ``sweep_rerun`` span asked for as (ids, profiling on), each chunk's
    escalation counts)."""
    reruns, sinks = [], []
    stage, retry = batch.stage, batch.retry_saturated_windows

    def spy_stage(name, **ids):
        if name == "sweep_rerun":
            reruns.append((ids, profiling.enabled()))
        return stage(name, **ids)

    def spy_retry(*args, escalation_sink=None, **kwargs):
        out = retry(*args, escalation_sink=escalation_sink, **kwargs)
        if escalation_sink is not None:
            sinks.append(dict(escalation_sink))
        return out

    profiling.METRICS.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch, "stage", spy_stage)
        mp.setattr(batch, "retry_saturated_windows", spy_retry)
        traj = pt.DLPOLY(path)
        traj.analysis_batched(batch_size=batch_size, device="cpu", **FF)
    snap = profiling.METRICS.snapshot()
    profiling.METRICS.reset()
    return {k: v["0"] for k, v in traj.analysis_output.items()}, snap, reruns, sinks


@pytest.fixture(scope="module")
def unlearned(history):
    """A sweep in chunks of 8 that learns no caps (``learn_caps=False``),
    with profiling off: every chunk re-runs its frames."""
    assert not profiling.enabled()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch, "_sweep_frames", functools.partial(batch._sweep_frames, learn_caps=False))
        return _sweep(history[0], 8)


@pytest.fixture(scope="module")
def learned(history):
    """Two sweeps in chunks of 4 with profiling on, ``LEARNED_CAPS``
    empty before the first and after the second.  The first sweep's
    last slab decodes only once a cap is learned, so its last chunk
    dispatches after the first chunk's escalation, as it does in a
    sweep of many chunks."""
    sweep_stream = batch.sweep_stream

    def held(elements, n_frames, decode_slab, *args, **kwargs):
        def decode(lo, hi, **outs):
            t0 = time.perf_counter()
            while hi == n_frames and not len(batch.LEARNED_CAPS):
                assert time.perf_counter() - t0 < HOLD_S, "no cap was learned"
                time.sleep(0.01)
            return decode_slab(lo, hi, **outs)

        return sweep_stream(elements, n_frames, decode, *args, **kwargs)

    batch.LEARNED_CAPS._caps.clear()
    profiling.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(batch, "sweep_stream", held)
            first = _sweep(history[0], 4)
        caps = list(batch.LEARNED_CAPS._caps.values())
        second = _sweep(history[0], 4)
    finally:
        profiling.enable(False)
        batch.LEARNED_CAPS._caps.clear()
    return first, second, caps


@pytest.fixture(scope="module")
def jax_swept(history):
    """The JAX package's sweep of the same file, in chunks of 8."""
    traj = pw.DLPOLY(history[0])
    traj.analysis_batched(batch_size=8, **FF)
    return {k: v["0"] for k, v in traj.analysis_output.items()}


def _windows_matched(g: dict, ref_diameters, ref_centres, k) -> tuple[float, float]:
    """(largest diameter gap, largest centre gap) of frame ``k``'s windows,
    each against the reference's nearest centre (window order ignored;
    every reference window matched once)."""
    d = np.asarray(g["windows"]["diameters"])
    c = np.asarray(g["windows"]["centre_of_mass"])
    rd, rc = np.asarray(ref_diameters), np.asarray(ref_centres)
    assert len(d) == len(rd) == 6, k
    near = [int(np.argmin(np.linalg.norm(rc - ci, axis=1))) for ci in c]
    assert sorted(near) == list(range(len(rd))), k
    return np.abs(d - rd[near]).max(), np.abs(c - rc[near]).max()


def test_sweep_matches_jax(history, unlearned, jax_swept):
    _, elements, coords = history
    got = unlearned[0]
    els = molecules.elements(elements, None, "DLF")
    radii = np.array([pw.tables.atomic_vdw_radius[e.upper()] for e in els])
    assert sorted(got) == sorted(jax_swept) == list(range(FRAMES))
    gaps = {"pore_opt": [], "diameter": [], "centre": []}
    for k in range(FRAMES):
        g, ref = got[k], jax_swept[k]
        assert sorted(g) == sorted(ref)
        for key in ("average_diameter", "pore_volume"):
            assert abs(g[key] - ref[key]) < EXACT, key
        for key in ("maximum_diameter", "pore_diameter"):
            assert abs(g[key]["diameter"] - ref[key]["diameter"]) < EXACT, key
        np.testing.assert_allclose(g["centre_of_mass"], ref["centre_of_mass"], atol=EXACT, rtol=0)
        for opt in (g["pore_diameter_opt"], ref["pore_diameter_opt"]):
            at = np.linalg.norm(coords[k] - np.asarray(opt["centre_of_mass"]), axis=1) - radii
            assert abs(opt["diameter"] - 2 * at.min()) < EXACT, k
        gaps["pore_opt"].append(abs(g["pore_diameter_opt"]["diameter"] - ref["pore_diameter_opt"]["diameter"]))
        gaps["centre"].append(
            np.abs(np.subtract(g["pore_diameter_opt"]["centre_of_mass"], ref["pore_diameter_opt"]["centre_of_mass"])).max()
        )
        d, c = _windows_matched(g, ref["windows"]["diameters"], ref["windows"]["centre_of_mass"], k)
        gaps["diameter"].append(d)
        gaps["centre"].append(c)
    for name, values in gaps.items():
        assert np.median(values) < JAX_MEDIAN, name
    assert max(gaps["pore_opt"] + gaps["diameter"]) < JAX_DIAMETER
    assert max(gaps["centre"]) < JAX_CENTRE


def test_sweep_matches_reference(history, unlearned):
    _, elements, coords = history
    got = unlearned[0]
    els = molecules.elements(elements, None, "DLF")
    pin = float(molecules.max_diameters(els, coords, "cpu").max())
    refs = pipeline.analyse([(els, c) for c in coords], pipeline.batch_sizes(pin, pin, pipeline.CFG), "cpu")
    gaps = {"pore_opt": [], "diameter": [], "centre": []}
    for k, ref in enumerate(refs):
        g = got[k]
        assert abs(g["maximum_diameter"]["diameter"] - ref["maximum_diameter"]) < EXACT
        assert abs(g["pore_diameter"]["diameter"] - ref["pore_diameter"]) < EXACT
        assert abs(g["average_diameter"] - ref["average_diameter"]) < EXACT
        np.testing.assert_allclose(g["centre_of_mass"], ref["centre_of_mass"], atol=EXACT, rtol=0)
        opt = g["pore_diameter_opt"]
        gaps["pore_opt"].append(abs(opt["diameter"] - ref["pore_diameter_opt"]))
        gaps["centre"].append(np.abs(opt["centre_of_mass"] - ref["pore_opt_centre"]).max())
        d, c = _windows_matched(g, ref["window_diameters"], ref["window_centres"], k)
        gaps["diameter"].append(d)
        gaps["centre"].append(c)
    for name, values in gaps.items():
        assert np.median(values) < MEDIAN, name
    assert max(gaps["pore_opt"] + gaps["diameter"]) < DIAMETER
    assert max(gaps["centre"]) < CENTRE


def test_first_sweep_learns_the_open_cap(learned):
    (_, snap, _, sinks), _, caps = learned
    counters = snap["counters"]
    assert sinks[0]["open_overflow"] == 4  # the first chunk's every frame
    assert counters["caps_learned.open_cap_frac"] == 1
    assert "caps_learned.max_windows" not in counters
    assert caps == [dataclasses.replace(DEFAULT_CONFIG, open_cap_frac=2 * DEFAULT_CONFIG.open_cap_frac)]
    # chunks dispatch in order and the live config only escalates, so
    # the last chunk (at least) ran at the learned cap
    assert counters["frames_at_learned_caps"] in (4, 8)
    assert counters["frames_retried.open_overflow"] == FRAMES - counters["frames_at_learned_caps"]
    assert "sweep_restarts" not in counters


def test_second_sweep_opens_at_the_learned_cap(learned):
    _, (_, snap, reruns, sinks), _ = learned
    counters = snap["counters"]
    assert counters["frames_at_learned_caps"] == FRAMES
    assert not any(k.startswith(("caps_learned.", "frames_retried.")) for k in counters)
    assert reruns == [] and all(s["open_overflow"] == 0 for s in sinks)


@pytest.mark.parametrize("which", [0, 1])
def test_learned_sweeps_equal_the_unlearned(learned, unlearned, which):
    got, base = learned[which][0], unlearned[0]
    assert sorted(got) == sorted(base) == list(range(FRAMES))
    for k in range(FRAMES):
        _assert_identical(got[k], base[k])


@pytest.mark.parametrize("on", [False, True])
def test_rerun_span_and_counters_only_while_profiling(learned, unlearned, on):
    _, snap, reruns, sinks = learned[0] if on else unlearned
    assert reruns and {ids["reason"] for ids, _ in reruns} == {"open_overflow"}
    assert {enabled for _, enabled in reruns} == {on}
    assert sum(s["open_overflow"] for s in sinks) > 0
    if on:
        assert 1 <= snap["stage_calls"]["sweep_rerun"] <= len(reruns)
        assert snap["counters"]["frames_retried.open_overflow"] > 0
    else:
        assert snap == {"counters": {}, "stage_seconds": {}, "stage_calls": {}}


def test_budget_reruns_gathered_at_the_learned_cap(history):
    """At the learned open cap, with a Nelder-Mead fast budget of 54
    iterations, frames of both chunks stop on a budget: the sweep holds
    them back and re-runs them in one batch, and its dicts equal those
    of the per-chunk re-runs bit for bit."""
    _, elements, coords = history
    coords = coords[:4]
    maxd = batch.frame_max_diameters(elements, coords, "cpu")
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, open_cap_frac=2 * DEFAULT_CONFIG.open_cap_frac, fast_nm_maxiter=54
    )

    def sweep(on_batch):
        batch.sweep_uniform(elements, coords, maxd, on_batch, cfg, batch_size=2, device="cpu")

    with pytest.MonkeyPatch.context() as mp:
        _per_chunk(mp)
        ref = _watched(sweep)
    got = _watched(sweep)
    budget = [s["budget"] for s in ref["sinks"]]
    assert got["sinks"] == ref["sinks"] and all(budget) and sum(budget) < 4
    assert ref["reruns"].count("budget") == 2 and got["reruns"].count("budget") == 1
    assert got["counters"]["frames_budget_gathered"] == got["counters"]["frames_retried.budget"] == sum(budget)
    assert len(got["deliveries"]) == 3 and sum(map(len, got["deliveries"])) == 4
    assert sorted(got["dicts"]) == sorted(ref["dicts"]) == list(range(4))
    for k in range(4):
        _assert_identical(got["dicts"][k], ref["dicts"][k])


@pytest.mark.parametrize(
    "spans,frames,want",
    [
        ({"sweep_open": 0.1, "sweep_rerun": 0.25}, 21600, 0.25 * 1e6 / 21600),
        ({"sweep_open": 0.1}, 21600, None),  # nothing re-ran, or no span in the program
        ({"sweep_dispatch": 0.2}, 21600, None),
        ({"sweep_open": 0.1, "sweep_rerun": 0.25}, 0, None),  # no frame done
    ],
    ids=["span", "no_span", "no_sweep", "no_frames"],
)
def test_rerun_reader(spans, frames, want):
    """``escalation.rerun_ms_per_kframe``: ``sweep_rerun`` seconds a
    thousand frames, and nothing where the span window has no re-run."""
    from portbench import run

    got = run.reader("escalation.rerun_ms_per_kframe")({"spans": spans, "span_units": {"frames": frames}})
    assert got == (None if want is None else pytest.approx(want))
