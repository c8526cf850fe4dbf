"""The optimiser kernels' two exact shortcuts, held on the CPU through
their plain versions and Python mirrors:

* ``nm_xy``'s grid cull (:func:`pywindow_torch.ops.nm_kernels.grid_keep`,
  the rule ``csrc/nm_xy.cu`` applies): every grid value, so the grid's
  first argmin and its minimum, is bit for bit the same over the kept
  atoms as over all atoms, on the window lanes of PUDXES and REYMAL and
  on 200 random lanes;
* the ``active`` lane flag: with it, the plain versions compute only the
  active lanes, which equal a run without the flag to the bit, and the
  inactive lanes hold the kernels' placeholders;

and the stable analysis that passes the flag (the card's configuration,
run on the CPU) against pywindow_tpu at the 0.01 Å contract: its float32
stable run for PUDXES and REYMAL, its float64 batch for CC3 HISTORY
frames.
"""

import numpy as np
import pytest
import torch

import pywindow_torch as pt
import pywindow_tpu as pw
from pywindow_torch.ops import _cuda, lbfgsb_kernels, nm_kernels
from pywindow_torch.ops.encoding import MolArrays, unmasked
from pywindow_torch.ops.geometry import clearance_diff
from pywindow_torch.ops.rays import linspace
from pywindow_torch.parallel import batch
from pywindow_tpu.parallel import batch as jbatch
from tests.conftest import DATA, load_structure

F32_CONTRACT = 0.01
HISTORY = DATA / "HISTORY_singlemol_short"


def _record_stable_lanes(name, monkeypatch):
    """The (args, kwargs) of every lbfgsb_stable and nm_xy plain call of a
    stable-mode (card configuration) analysis of ``name`` on the CPU."""
    monkeypatch.setenv("PYWINDOW_TORCH_FORCE_F32", "1")
    calls = {"lbfgsb": [], "nm": []}
    plain_l, plain_n = lbfgsb_kernels.lbfgsb_stable_flat_plain, nm_kernels.nm_xy_flat_plain

    def rec_l(*args, **kwargs):
        calls["lbfgsb"].append((args, kwargs))
        return plain_l(*args, **kwargs)

    def rec_n(*args, **kwargs):
        calls["nm"].append((args, kwargs))
        return plain_n(*args, **kwargs)

    monkeypatch.setattr(lbfgsb_kernels, "lbfgsb_stable_flat_plain", rec_l)
    monkeypatch.setattr(nm_kernels, "nm_xy_flat_plain", rec_n)
    props = pt.MolecularSystem.load_file(DATA / f"{name}.xyz").system_to_molecule().full_analysis(
        device="cpu"
    )
    monkeypatch.setattr(lbfgsb_kernels, "lbfgsb_stable_flat_plain", plain_l)
    monkeypatch.setattr(nm_kernels, "nm_xy_flat_plain", plain_n)
    return calls, props


def _random_lanes(lanes=200, seed=11, n=96, pad=104):
    """Window-xy lanes of hollow random shells (a pore at the centre) and
    of random blobs, with random z anchors and grid half-widths."""
    rng = np.random.default_rng(seed)
    coords = np.full((lanes, pad, 3), 1.0e6)
    vdw = np.zeros((lanes, pad))
    for i in range(lanes):
        if i % 4 == 3:
            pts = rng.normal(size=(n, 3)) * 6.0
        else:
            pts = rng.normal(size=(n, 3))
            pts /= np.linalg.norm(pts, axis=1, keepdims=True)
            pts = pts * rng.uniform(5.0, 8.0) + rng.normal(scale=0.3, size=(n, 3))
        coords[i, :n] = pts
        vdw[i, :n] = rng.uniform(1.2, 1.8, n)
    z = rng.normal(scale=0.5, size=lanes)
    half = rng.uniform(0.5, 3.0, lanes)
    return tuple(torch.tensor(a, dtype=torch.float64) for a in (coords, vdw, z, half))


def _grid_values(coords, vdw, zanchor, half, mask, ns=20):
    """f at every point of the brute grid (x outer, as brute_start lays
    it out) over the atoms where ``mask`` is True: (L, ns * ns)."""
    dtype = coords.dtype
    gx = linspace(-half, half, ns, dtype, coords.device)
    grid = torch.stack([gx.repeat_interleave(ns, dim=1), gx.repeat(1, ns)], -1)
    disp = torch.cat([grid, torch.zeros_like(grid[..., :1])], -1)
    zero = torch.zeros_like(zanchor)
    anchor = torch.stack([zero, zero, zanchor], -1)
    mol = MolArrays(coords, vdw, vdw, vdw, mask)
    return -2.0 * clearance_diff(anchor, disp, mol)


def _assert_cull_exact(coords, vdw, zanchor, half):
    keep = nm_kernels.grid_keep(coords, vdw, zanchor, half)
    every = torch.ones_like(keep)
    full = _grid_values(coords, vdw, zanchor, half, every)
    kept = _grid_values(coords, vdw, zanchor, half, keep)
    assert torch.equal(full, kept)
    assert torch.equal(full.argmin(-1), kept.argmin(-1))
    assert torch.equal(full.amin(-1), kept.amin(-1))
    # padded atoms always go
    assert not bool((keep & (vdw == 0)).any())
    return keep.sum(-1)


@pytest.mark.parametrize("name", ["PUDXES", "REYMAL"])
def test_grid_cull_keeps_every_grid_value_on_window_lanes(name, monkeypatch):
    calls, _ = _record_stable_lanes(name, monkeypatch)
    assert calls["nm"], "the stable analysis made no nm_xy call"
    for args, kwargs in calls["nm"]:
        coords, vdw, zanchor, half = args
        kept = _assert_cull_exact(coords, vdw, zanchor, half)
        n_real = int((vdw[0] > 0).sum())
        assert int(kept.max()) < n_real


def test_grid_cull_keeps_every_grid_value_on_random_lanes():
    coords, vdw, zanchor, half = _random_lanes()
    _assert_cull_exact(coords, vdw, zanchor, half)


@pytest.mark.parametrize("name", ["PUDXES", "REYMAL"])
def test_plain_versions_with_active_equal_the_run_without(name, monkeypatch):
    """On the recorded window lanes (whose empty slots the analysis
    flagged inactive): the active lanes equal a run without the flag,
    the inactive ones hold the placeholders."""
    calls, _ = _record_stable_lanes(name, monkeypatch)
    z_calls = [(a, k) for a, k in calls["lbfgsb"] if k.get("active") is not None]
    assert z_calls and all(a[3].shape[1] == 1 for a, _ in z_calls)
    pore = [k for a, k in calls["lbfgsb"] if a[3].shape[1] == 3]
    assert pore and all(k.get("active") is None for k in pore)
    for args, kwargs in z_calls:
        active = kwargs["active"]
        assert not bool(active.all()), "no empty window slot to skip"
        rest = {k: v for k, v in kwargs.items() if k != "active"}
        with_flag = lbfgsb_kernels.lbfgsb_stable_flat_plain(*args, **kwargs)
        without = lbfgsb_kernels.lbfgsb_stable_flat_plain(*args, **rest)
        for a, b in zip(with_flag, without):
            assert torch.equal(a[active], b[active])
        assert torch.equal(with_flag[0][~active], args[3][~active])
        for out in with_flag[1:]:
            assert not bool(out[~active].any())
    for args, kwargs in calls["nm"]:
        active = kwargs["active"]
        rest = {k: v for k, v in kwargs.items() if k != "active"}
        with_flag = nm_kernels.nm_xy_flat_plain(*args, **kwargs)
        without = nm_kernels.nm_xy_flat_plain(*args, **rest)
        for a, b in zip(with_flag, without):
            assert torch.equal(a[active], b[active])
        for out in with_flag:
            assert not bool(out[~active].any())


@pytest.mark.parametrize("pattern", ["alternate", "none", "all"])
def test_plain_versions_with_active_on_random_lanes(pattern):
    coords, vdw, zanchor, half = _random_lanes(lanes=12, seed=5)
    active = {
        "alternate": torch.arange(12) % 2 == 0,
        "none": torch.zeros(12, dtype=torch.bool),
        "all": torch.ones(12, dtype=torch.bool),
    }[pattern]
    with_flag = nm_kernels.nm_xy_flat_plain(coords, vdw, zanchor, half, active=active, maxiter=60)
    without = nm_kernels.nm_xy_flat_plain(coords, vdw, zanchor, half, maxiter=60)
    for a, b in zip(with_flag, without):
        assert torch.equal(a[active], b[active])
        assert not bool(a[~active].any())
    rng = np.random.default_rng(5)
    origin = torch.tensor(
        np.concatenate([rng.normal(scale=0.4, size=(12, 2)), np.zeros((12, 1))], -1)
    )
    x0 = torch.zeros((12, 1), dtype=torch.float64)
    lo = torch.tensor(-rng.uniform(1, 3, (12, 1)))
    up = torch.full_like(lo, 1e10)
    kw = dict(emb=lbfgsb_kernels.EMB_Z, sign=1.0, maxiter=30)
    with_flag = lbfgsb_kernels.lbfgsb_stable_flat_plain(
        coords, vdw, origin, x0, lo, up, active=active, **kw
    )
    without = lbfgsb_kernels.lbfgsb_stable_flat_plain(coords, vdw, origin, x0, lo, up, **kw)
    for a, b in zip(with_flag, without):
        assert torch.equal(a[active], b[active])


def test_active_flag_checks_and_placeholders():
    x0 = torch.tensor([[1.5], [2.5], [3.5]], dtype=torch.float64)
    calls = []

    def fn(*lanes):
        calls.append(lanes[0].shape[0])
        return (lanes[0] * 2.0,)

    out = _cuda.on_active_lanes(
        torch.tensor([False, True, False]), fn, (x0,), (x0.clone(),)
    )
    assert calls == [1] and torch.equal(out[0], torch.tensor([[1.5], [5.0], [3.5]], dtype=torch.float64))
    _cuda.on_active_lanes(torch.zeros(3, dtype=torch.bool), fn, (x0,), (x0.clone(),))
    assert calls == [1]
    assert _cuda.on_active_lanes(None, fn, (x0,), ())[0].shape == (3, 1)
    _cuda.check_active("k", None, 3)
    with pytest.raises(TypeError, match="bool"):
        _cuda.check_active("k", torch.ones(3), 3)
    with pytest.raises(ValueError, match="shape"):
        _cuda.check_active("k", torch.ones(4, dtype=torch.bool), 3)
    for lanes in (1, 8, 384, 1440, 11520):
        threads, capped = lbfgsb_kernels.lane_launch(lanes, 168, 132)
        assert threads % 32 == 0 and 32 <= threads <= 256 and (threads == 32 or not capped)
        threads = nm_kernels.lane_threads(lanes, 168, 132)
        assert threads % 64 == 0 and 64 <= threads <= 256
    assert lbfgsb_kernels.lane_launch(1440, 168, 132) == (32, True)
    assert lbfgsb_kernels.lane_launch(1, 472, 132) == (256, False)
    assert nm_kernels.lane_threads(11520, 168, 132) == 64


@pytest.mark.parametrize("name", ["PUDXES", "REYMAL"])
def test_stable_full_analysis_matches_jax(name, monkeypatch):
    """The card's configuration (float32 pipeline, stable optimisers that
    skip the empty window slots) on the CPU against pywindow_tpu's
    float32 stable run, at the 0.01 Å contract."""
    calls, props = _record_stable_lanes(name, monkeypatch)
    assert any(k.get("active") is not None for _, k in calls["nm"])
    monkeypatch.setenv("PYWINDOW_TPU_FORCE_F32", "1")
    elements, coords = load_structure(name)
    ref = pw.Molecule({"elements": elements, "coordinates": coords}).full_analysis()
    for key in ("maximum_diameter", "pore_diameter", "pore_diameter_opt"):
        assert props[key]["diameter"] == pytest.approx(ref[key]["diameter"], abs=F32_CONTRACT)
    got_w = np.sort(np.asarray(props["windows"]["diameters"]))
    ref_w = np.sort(np.asarray(ref["windows"]["diameters"]))
    assert len(got_w) == len(ref_w)
    np.testing.assert_allclose(got_w, ref_w, atol=F32_CONTRACT)


def test_stable_batched_sweep_matches_jax(monkeypatch):
    """Six CC3 HISTORY frames through analyze_batch in the card's
    configuration against pywindow_tpu's float64 batch (the reference
    values; its float32 run keeps the optimiser state in float32, which
    the port does not, ROADMAP Q3.3), at the 0.01 Å contract, on frames
    where the float64 reference is not chaotic (on frames 6, 8 and 9 its
    classic FD driver stops 0.014-0.029 Å away, ROADMAP Q3.4)."""
    monkeypatch.setenv("PYWINDOW_TORCH_FORCE_F32", "1")
    fr = pt.DLPOLY(HISTORY).get_frames([2, 4, 10, 11, 15, 19], swap_atoms={"he": "H"}, forcefield="OPLS")
    systems = [(m.system["elements"], m.system["coordinates"]) for m in fr.values()]
    got = batch.analyze_batch(systems, device="cpu")
    ref = jbatch.analyze_batch(systems)
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert g["pore_diameter_opt"]["diameter"] == pytest.approx(
            r["pore_diameter_opt"]["diameter"], abs=F32_CONTRACT
        )
        gw, rw = g["windows"]["diameters"], r["windows"]["diameters"]
        assert (gw is None) == (rw is None)
        if gw is not None:
            assert len(gw) == len(rw)
            np.testing.assert_allclose(np.sort(gw), np.sort(rw), atol=F32_CONTRACT)


def test_unmasked_grid_matches_the_plain_objective():
    """The test's grid helper is the plain version's objective: the first
    argmin of its values is the point brute_start picks."""
    from pywindow_torch.ops import optim

    coords, vdw, zanchor, half = _random_lanes(lanes=6, seed=3)
    values = _grid_values(coords, vdw, zanchor, half, torch.ones_like(vdw, dtype=torch.bool))
    zero = torch.zeros_like(zanchor)
    anchor = torch.stack([zero, zero, zanchor], -1)

    def f_xy(xys):
        disp = torch.cat([xys, torch.zeros_like(xys[..., :1])], -1)
        return -2.0 * clearance_diff(anchor, disp, unmasked(coords, vdw))

    start = optim.brute_start(f_xy, torch.stack([-half, -half], -1), torch.stack([half, half], -1), 20)
    idx = values.argmin(-1)
    gx = linspace(-half, half, 20, torch.float64, "cpu")
    picked = torch.stack([gx.gather(1, (idx // 20)[:, None])[:, 0], gx.gather(1, (idx % 20)[:, None])[:, 0]], -1)
    assert torch.equal(start, picked)
