"""The exact atom culls of the three ray kernels, held on the CPU through
their Python mirrors and the plain versions:

* ``path_sweep`` (:func:`~pywindow_torch.ops.ray_kernels.path_sweep_keep`,
  the rule of ``csrc/path_sweep.cu``): the plain version over each ray's
  kept atoms (the others parked at 1e6 with vdW 0) equals it over all
  atoms, ``torch.equal`` on ok, pos and cmin; and no probe's clearance of
  an atom lies below that atom's bound;
* ``fine_path`` (the same rule, ``csrc/ray_cull.cuh``, on the window-slot
  rays): ``fine_path_plain`` over each slot's kept atoms equals it over all
  atoms, ``fine_path_plain`` equals ``path_sweep_plain`` bit for bit, the
  ``active`` slots' outputs do not depend on the others, and no output of
  ``full_analysis`` changes when only the active slots are walked;
* ``ray_exit`` (:func:`~pywindow_torch.ops.ray_kernels.ray_exit_keep`,
  the cone rule of ``csrc/ray_exit.cu``, over the tiles of
  :func:`~pywindow_torch.ops.rays.spiral_tile_order`): every (ray, atom)
  pair whose ``under`` (the kernel's operations in its order) is positive
  keeps its atom, and the plain version over each tile's kept atoms
  equals it over all atoms;

in float64 and float32, on PUDXES's and REYMAL's main-path calls
(``full_analysis(device="cpu")``, float64 and the card's float32
configuration), on random molecules and on adversarial inputs.  The
mirrors model the kernels' rules with the kernels' operations: they show
that the rules skip only pairs that count for nothing, not what a kernel
does on the card.  That is held by the card tests and by
``chip_smoke.py``, which compare each kernel with its plain version (and
``ray_exit`` with its own pair arithmetic over every atom) bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import pywindow_torch as pt
from pywindow_torch.ops import ray_kernels as rk
from pywindow_torch.ops import rays
from pywindow_torch.ops.geometry import sq_norm3
from tests.conftest import DATA

DTYPES = [torch.float64, torch.float32]


# -- path_sweep -----------------------------------------------------------


def _assert_sweep_cull_exact(vectors, chunks, coords, vdw, max_steps):
    """The two checks of the module docstring; returns the kept counts."""
    keep = rk.path_sweep_keep(vectors, chunks, coords, vdw, max_steps)
    b, p = vectors.shape[:2]
    n = coords.shape[1]
    co_k = torch.where(keep[..., None], coords[:, None], 1.0e6).reshape(b * p, n, 3)
    vd_k = torch.where(keep, vdw[:, None], 0.0).reshape(b * p, n)
    full = rk.path_sweep_plain(vectors, chunks, coords, vdw, max_steps)
    part = rk.path_sweep_plain(
        vectors.reshape(b * p, 1, 3), chunks.reshape(b * p, 1), co_k, vd_k, max_steps
    )
    for f, q in zip(full, part):
        assert torch.equal(f.reshape(-1), q.reshape(-1))
    # every valid probe's clearance of every atom is >= the atom's bound
    lb = rk.path_sweep_bounds(vectors, coords, vdw)  # (B, P, N)
    dtype = vectors.dtype
    steps = torch.arange(max_steps, dtype=dtype)
    frac = steps / chunks[..., None].to(dtype)
    q = vectors[..., None, :] * frac[..., None]  # (B, P, L, 3)
    c = torch.sqrt(sq_norm3(q[..., :, None, :] - coords[:, None, None, :, :])) - vdw[:, None, None, :]
    valid = (steps.to(torch.int32) <= chunks[..., None])[..., None]
    assert bool(((c >= lb[..., None, :]) | ~valid).all())
    return keep.sum(-1)


def _shell(n, seed, dtype, pad=0, b=1):
    """(coords, vdw) of b hollow random shells with n atoms, and ``pad``
    padded atoms parked at 1e6 with vdW 0."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = pts * rng.uniform(5.0, 8.0, (b, 1, 1)) + rng.normal(scale=0.4, size=(b, n, 3))
    coords = np.concatenate([pts, np.full((b, pad, 3), 1.0e6)], 1)
    vdw = np.concatenate([rng.uniform(1.2, 1.9, (b, n)), np.zeros((b, pad))], 1)
    return torch.tensor(coords, dtype=dtype), torch.tensor(vdw, dtype=dtype)


def _spiral_rays(p, radius, dtype, b=1):
    r = torch.full((b,), radius, dtype=dtype)
    return rays.golden_spiral(p, r)


@functools.cache
def _main_path_calls(name: str, f32: bool):
    """Every ray_exit, path_sweep and fine_path call of
    ``full_analysis(device="cpu")``: float64, or the card's float32
    configuration."""
    import os

    calls = {"ray_exit": [], "path_sweep": [], "fine_path": []}
    exit_fn, sweep_fn, fine_fn = rk.ray_exit, rk.path_sweep, rk.fine_path

    def exit_rec(unit, rel, vdw, origin, want_exit, order):
        calls["ray_exit"].append((unit, rel, vdw, origin, want_exit, order))
        return exit_fn(unit, rel, vdw, origin, want_exit, order)

    def sweep_rec(*args):
        calls["path_sweep"].append(args)
        return sweep_fn(*args)

    def fine_rec(*args):
        calls["fine_path"].append(args)
        return fine_fn(*args)

    old = os.environ.get("PYWINDOW_TORCH_FORCE_F32")
    rk.ray_exit, rk.path_sweep, rk.fine_path = exit_rec, sweep_rec, fine_rec
    try:
        if f32:
            os.environ["PYWINDOW_TORCH_FORCE_F32"] = "1"
        mol = pt.MolecularSystem.load_file(DATA / f"{name}.xyz").system_to_molecule()
        mol.full_analysis(device="cpu")
    finally:
        rk.ray_exit, rk.path_sweep, rk.fine_path = exit_fn, sweep_fn, fine_fn
        if old is None:
            os.environ.pop("PYWINDOW_TORCH_FORCE_F32", None)
        else:
            os.environ["PYWINDOW_TORCH_FORCE_F32"] = old
    return calls


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("name", ["PUDXES", "REYMAL"])
def test_sweep_cull_exact_on_main_path_calls(name, f32):
    calls = _main_path_calls(name, f32)["path_sweep"]
    assert calls
    for vectors, chunks, coords, vdw, max_steps in calls:
        assert vectors.dtype == (torch.float32 if f32 else torch.float64)
        kept = _assert_sweep_cull_exact(vectors, chunks, coords, vdw, max_steps)
        open_rays = ~(vectors == 0).all(-1)
        # the cull's point: a few atoms decide every open ray
        assert float(kept[open_rays].double().mean()) < 3.0
        assert int(kept.max()) < int((vdw[0] > 0).sum())


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_cull_exact_on_random_molecules(dtype):
    coords, vdw = _shell(150, 3, dtype, pad=10, b=3)
    vectors = _spiral_rays(200, 7.5, dtype, b=3)
    vectors = vectors * torch.tensor([1.0, 0.6, 1.3], dtype=dtype)[:, None, None]
    _, chunks = rays._chunks(vectors, 0.5)
    _assert_sweep_cull_exact(vectors, chunks, coords, vdw, 20)


def _line_case(dtype):
    """Rays along +x with chunks 8 (probes at 0.5 A); atoms placed so that
    a sphere's surface passes within an ulp of the probe at x = 1.5."""
    one = torch.tensor(1.5, dtype=dtype)
    d = torch.tensor(2.25, dtype=dtype)
    radii = [d, torch.nextafter(d, torch.tensor(0.0, dtype=dtype)), torch.nextafter(d, torch.tensor(9.0, dtype=dtype))]
    coords, vdw, vecs = [], [], []
    rng = np.random.default_rng(0)
    far = rng.normal(size=(20, 3))
    far = far / np.linalg.norm(far, axis=1, keepdims=True) * rng.uniform(8.0, 12.0, (20, 1))
    for r in radii:
        atoms = np.concatenate([[[float(one), float(d), 0.0]], far])
        coords.append(atoms)
        vdw.append(np.concatenate([[float(r)], np.full(20, 1.5)]))
        vecs.append([[4.0, 0.0, 0.0]])
    coords = torch.tensor(np.stack(coords), dtype=dtype)
    vdw = torch.tensor(np.stack(vdw), dtype=dtype)
    vdw[:, 0] = torch.stack(radii)
    vectors = torch.tensor(np.stack(vecs), dtype=dtype)
    chunks = torch.full((3, 1), 8, dtype=torch.int32)
    return vectors, chunks, coords, vdw


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_cull_exact_with_a_surface_within_an_ulp_of_a_probe(dtype):
    vectors, chunks, coords, vdw = _line_case(dtype)
    _assert_sweep_cull_exact(vectors, chunks, coords, vdw, 12)
    ok, _, cmin = rk.path_sweep_plain(vectors, chunks, coords, vdw, 12)
    assert not bool(ok[0, 0]) and float(cmin[0, 0]) == 0.0  # the surface on the probe


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_cull_exact_on_adversarial_rays(dtype):
    """Zero rays (chunks 1), max_steps below chunks + 1, max_steps above
    32 (the kernel wraps its steps), rays blocked by an atom on the
    segment (U < 0), an atom containing the origin, and padded atoms."""
    coords, vdw = _shell(60, 4, dtype, pad=4, b=2)
    rng = np.random.default_rng(4)
    vec = rng.normal(size=(2, 40, 3))
    vec = vec / np.linalg.norm(vec, axis=-1, keepdims=True) * rng.uniform(2.0, 12.0, (2, 40, 1))
    vec[:, :8] = 0.0  # zero rays
    vectors = torch.tensor(vec, dtype=dtype)
    _, chunks = rays._chunks(vectors, 0.25)  # up to 48 steps
    chunks[:, :8] = 1
    # frame 1: an atom on ray 10's segment and one containing the origin
    coords[1, 0] = vectors[1, 10] * 0.5
    coords[1, 1] = torch.tensor([0.3, -0.2, 0.1], dtype=dtype)
    vdw[1, 1] = 1.0
    for max_steps in (5, 16, 49):
        _assert_sweep_cull_exact(vectors, chunks, coords, vdw, max_steps)
    ok, _, cmin = rk.path_sweep_plain(vectors, chunks, coords, vdw, 49)
    assert float(cmin[1, 10]) < 0.0 and not bool(ok[1].any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_cull_keeps_every_atom_of_an_equidistant_cylinder(dtype):
    """Atoms on a cylinder around the ray, one ring at each probe: every
    atom's bound reaches U, so nothing can be culled."""
    steps, ring = 9, 8
    ang = np.arange(ring) * 2 * np.pi / ring
    atoms = [
        [0.5 * l, 3.0 * np.cos(a), 3.0 * np.sin(a)] for l in range(steps) for a in ang
    ]
    coords = torch.tensor([atoms], dtype=dtype)
    vdw = torch.full((1, len(atoms)), 1.25, dtype=dtype)
    vectors = torch.tensor([[[4.0, 0.0, 0.0]]], dtype=dtype)
    chunks = torch.full((1, 1), 8, dtype=torch.int32)
    kept = _assert_sweep_cull_exact(vectors, chunks, coords, vdw, 12)
    assert int(kept[0, 0]) == len(atoms)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_origin_rays_take_the_origin_clearance(dtype):
    """The rays the kernel answers from its block's origin clearance c0
    (zero vectors, chunks >= 1, a step at least) have the plain version's
    (c0 > 0, 0, c0); a zero ray with no step is walked."""
    coords, vdw = _shell(60, 8, dtype, pad=4, b=2)
    coords[1, 0] = torch.tensor([0.3, -0.2, 0.1], dtype=dtype)  # around the origin
    vdw[1, 0] = 1.0
    vectors = _spiral_rays(24, 9.0, dtype, b=2)
    vectors[:, 16:] = 0.0
    vectors[0, 20] = -0.0
    _, chunks = rays._chunks(vectors, 0.5)
    chunks[:, 16:] = torch.arange(1, 9, dtype=torch.int32)
    for max_steps in (0, 1, 16):
        at_origin = rk.path_sweep_origin_rays(vectors, chunks, max_steps)
        assert bool(at_origin[:, 16:].all()) == (max_steps > 0)
        assert not bool(at_origin[:, :16].any())
        if max_steps == 0:
            continue
        ok, pos, cmin = rk.path_sweep_plain(vectors, chunks, coords, vdw, max_steps)
        c0 = (torch.sqrt(sq_norm3(-coords)) - vdw).amin(-1)[:, None].expand_as(cmin)
        assert torch.equal(cmin[at_origin], c0[at_origin])
        assert not bool(pos[at_origin].any())
        assert torch.equal(ok[at_origin], (c0 > 0.0)[at_origin])
        assert not bool(ok[1, 16:].any())


@pytest.mark.parametrize(
    ("frames", "want"), [(1, 1), (8, 1), (22, 1), (23, 2), (44, 2), (45, 4), (1440, 4)]
)
def test_sweep_rays_per_warp_fills_one_wave(frames, want):
    """384 rays a frame on 132 SMs (1,056 blocks a wave): one ray a warp
    while 48 blocks a frame fit, two while 24 do, else four."""
    assert rk.sweep_rays_per_warp(frames, 384, 132) == want


def test_sweep_bounds_guard_tiny_vectors():
    """A ray shorter than 2^-50 A is taken as the origin with |v| added to
    the margin, and the bound still holds."""
    coords, vdw = _shell(30, 6, torch.float64)
    vectors = torch.tensor([[[1e-60, 0.0, 0.0], [0.0, 0.0, 0.0], [3.0, 1.0, 0.0]]], dtype=torch.float64)
    chunks = torch.ones((1, 3), dtype=torch.int32)
    _assert_sweep_cull_exact(vectors, chunks, coords, vdw, 4)


# -- fine_path --------------------------------------------------------------


def _assert_fine_cull_exact(vectors, chunks, coords, vdw, max_steps):
    """``fine_path_plain`` over each slot's kept atoms (``path_sweep_keep``,
    the rule the two walks share; the others parked at 1e6 with vdW 0)
    equals it over all atoms, ``torch.equal``; returns the kept counts."""
    keep = rk.path_sweep_keep(vectors, chunks, coords, vdw, max_steps)
    b, w = vectors.shape[:2]
    n = coords.shape[1]
    co_k = torch.where(keep[..., None], coords[:, None], 1.0e6).reshape(b * w, n, 3)
    vd_k = torch.where(keep, vdw[:, None], 0.0).reshape(b * w, n)
    full = rk.fine_path_plain(vectors, chunks, coords, vdw, max_steps)
    part = rk.fine_path_plain(
        vectors.reshape(b * w, 1, 3), chunks.reshape(b * w, 1), co_k, vd_k, max_steps
    )
    for f, q in zip(full, part):
        assert torch.equal(f.reshape(-1), q.reshape(-1))
    return keep.sum(-1)


def _fine_main_calls(name, f32):
    calls = _main_path_calls(name, f32)["fine_path"]
    assert calls
    for vectors, chunks, coords, vdw, max_steps, active in calls:
        assert vectors.dtype == (torch.float32 if f32 else torch.float64)
        assert active is not None and active.shape == chunks.shape
    return calls


def _adversarial_slots(dtype):
    """(vectors, chunks, coords, vdw) of 2 frames of W = 8 slots: zero rays,
    a ray blocked on its segment, an atom around the origin, padded atoms."""
    coords, vdw = _shell(60, 9, dtype, pad=4, b=2)
    rng = np.random.default_rng(9)
    vec = rng.normal(size=(2, 8, 3))
    vec = vec / np.linalg.norm(vec, axis=-1, keepdims=True) * rng.uniform(2.0, 11.0, (2, 8, 1))
    vec[0, :2] = 0.0
    vectors = torch.tensor(vec, dtype=dtype)
    _, chunks = rays._chunks(vectors, 0.1)
    coords[1, 0] = vectors[1, 3] * 0.5
    coords[1, 1] = torch.tensor([0.3, -0.2, 0.1], dtype=dtype)
    vdw[1, 1] = 1.0
    return vectors, chunks, coords, vdw


@pytest.mark.parametrize("case", ["PUDXES-f64", "PUDXES-f32", "REYMAL-f64", "REYMAL-f32", "random-f64", "random-f32"])
def test_fine_path_plain_equals_path_sweep_plain(case):
    """The JAX package's step-chunked scan (strict < across 16-step
    blocks) gives the dense walk's outputs bit for bit: the same first
    minimum."""
    name, dt = case.split("-")
    if name == "random":
        dtype = torch.float64 if dt == "f64" else torch.float32
        vectors, chunks, coords, vdw = _adversarial_slots(dtype)
        calls = [(vectors, chunks, coords, vdw, steps) for steps in (5, 16, 33, 120)]
    else:
        calls = [c[:5] for c in _fine_main_calls(name, dt == "f32")]
    for args in calls:
        fine = rk.fine_path_plain(*args)
        dense = rk.path_sweep_plain(*args)
        for a, b in zip(fine, dense):
            assert torch.equal(a, b)


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("name", ["PUDXES", "REYMAL"])
def test_fine_cull_exact_on_main_path_calls(name, f32):
    for vectors, chunks, coords, vdw, max_steps, active in _fine_main_calls(name, f32):
        kept = _assert_fine_cull_exact(vectors, chunks, coords, vdw, max_steps)
        # the cull's point: a few atoms decide every window ray
        assert float(kept[active].double().mean()) < 3.0
        assert int(kept.max()) < int((vdw[0] > 0).sum())


@pytest.mark.parametrize("dtype", DTYPES)
def test_fine_cull_exact_on_adversarial_slots(dtype):
    vectors, chunks, coords, vdw = _adversarial_slots(dtype)
    for max_steps in (5, 16, 33, 120):
        _assert_fine_cull_exact(vectors, chunks, coords, vdw, max_steps)
    ok, _, cmin = rk.fine_path_plain(vectors, chunks, coords, vdw, 120)
    assert float(cmin[1, 3]) < 0.0 and not bool(ok[1].any())


@pytest.mark.parametrize("case", ["PUDXES-f64", "PUDXES-f32", "REYMAL-f64", "REYMAL-f32", "random-f64", "random-f32"])
def test_fine_path_active_slots(case):
    """With ``active``, the active slots' outputs equal the run without it
    and the others hold the placeholders (not ok, step 0, 1e30); on the
    main path ``active`` is ``find_windows``' ``exists`` (half the slots
    of a cage hold no window)."""
    name, dt = case.split("-")
    if name == "random":
        dtype = torch.float64 if dt == "f64" else torch.float32
        vectors, chunks, coords, vdw = _adversarial_slots(dtype)
        active = torch.tensor(np.random.default_rng(5).random((2, 8)) > 0.5)
        active[1] = False  # a frame with no active slot
        calls = [(vectors, chunks, coords, vdw, 40, active)]
    else:
        calls = _fine_main_calls(name, dt == "f32")
    for *args, active in calls:
        assert bool(active.any()) and not bool(active.all())
        full = rk.fine_path_plain(*args)
        part = rk.fine_path_plain(*args, active)
        for f, q in zip(full, part):
            assert torch.equal(f[active], q[active])
        ok, pos, cmin = part
        assert not bool(ok[~active].any()) and not bool(pos[~active].any())
        assert bool((cmin[~active] == 1e30).all())


def _props_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _props_equal(a[k], b[k])
    elif a is None or isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("name", ["PUDXES", "BATVUP"])
def test_full_analysis_unchanged_by_fine_path_active_slots(name, f32, monkeypatch):
    """Every output of ``full_analysis(device="cpu")`` is the same whether
    ``fine_path`` walks only the slots that hold a window or every slot:
    float64 runs the "classic" window optimisers, whose lanes see the
    inactive slots' placeholders but are never read there."""
    if f32:
        monkeypatch.setenv("PYWINDOW_TORCH_FORCE_F32", "1")
    path = DATA / f"{name}.xyz"
    got = pt.MolecularSystem.load_file(path).system_to_molecule().full_analysis(device="cpu")
    fine_fn = rk.fine_path
    monkeypatch.setattr(rk, "fine_path", lambda *args: fine_fn(*args[:5]))
    every = pt.MolecularSystem.load_file(path).system_to_molecule().full_analysis(device="cpu")
    _props_equal(got, every)


# -- ray_exit -------------------------------------------------------------


def _kernel_under(unit, rel, vdw):
    """(B, P, N) under = r^2 - |rel - t_ca u|^2 with the kernel's
    operations in its order (ray_exit.cu's pair loop)."""
    u0, u1, u2 = (unit[..., :, None, k] for k in range(3))
    x0, x1, x2 = (rel[..., None, :, k] for k in range(3))
    t_ca = u0 * x0 + u1 * x1 + u2 * x2
    q0 = x0 - t_ca * u0
    q1 = x1 - t_ca * u1
    q2 = x2 - t_ca * u2
    d2 = q0 * q0 + q1 * q1 + q2 * q2
    r = vdw[..., None, :]
    return r * r - d2


def _assert_exit_cull_exact(unit, rel, vdw, origin, order):
    """The two ray_exit checks of the module docstring; returns the kept
    counts per tile."""
    keep = rk.ray_exit_keep(unit, rel, vdw, order)  # (B, T, N)
    b, p, _ = unit.shape
    n = rel.shape[1]
    order = order.to(torch.int64)
    tile_of = torch.empty(p, dtype=torch.int64)
    tile_of[order] = torch.arange(p) // rk.RAY_TILE
    keep_ray = keep[:, tile_of]  # (B, P, N)
    under = _kernel_under(unit, rel, vdw)
    assert not bool((under > 0.0)[~keep_ray].any()), "a pair with under > 0 lost its atom"
    rel_k = torch.where(keep_ray[..., None], rel[:, None], 0.0).reshape(b * p, n, 3)
    vdw_k = torch.where(keep_ray, vdw[:, None], 0.0).reshape(b * p, n)
    origin_k = origin.repeat_interleave(p, 0)
    for want in (True, False):
        full = rk.ray_exit_plain(unit, rel, vdw, origin, want)
        part = rk.ray_exit_plain(unit.reshape(b * p, 1, 3), rel_k, vdw_k, origin_k, want)
        for f, q in zip(full, part):
            assert torch.equal(f.reshape(-1), q.reshape(-1))
    return keep.sum(-1)


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("name", ["PUDXES", "REYMAL"])
def test_exit_cull_exact_on_main_path_calls(name, f32):
    calls = _main_path_calls(name, f32)["ray_exit"]
    assert len(calls) >= 2 and {c[4] for c in calls} == {True, False}
    for unit, rel, vdw, origin, _, order in calls:
        assert order is not None and unit.dtype == (torch.float32 if f32 else torch.float64)
        kept = _assert_exit_cull_exact(unit, rel, vdw, origin, order)
        # compact tiles keep under a quarter of the atoms on average
        assert float(kept.double().mean()) < 0.25 * rel.shape[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["spiral", "identity", "reversed", "random"])
def test_exit_cull_exact_on_random_molecules_in_any_order(dtype, which):
    coords, vdw = _shell(120, 7, dtype, pad=8, b=2)
    mask = vdw > 0
    origin = (coords * mask[..., None]).sum(1) / mask.sum(1, keepdim=True)
    rel = torch.where(mask[..., None], coords - origin[:, None], 0.0)
    pts = _spiral_rays(333, 12.0, dtype, b=2)
    unit = pts / torch.sqrt(sq_norm3(pts))[..., None]
    order = {
        "spiral": rays.spiral_tile_order(333, torch.device("cpu")),
        "identity": torch.arange(333, dtype=torch.int32),
        "reversed": torch.arange(332, -1, -1, dtype=torch.int32),
        "random": torch.tensor(np.random.default_rng(1).permutation(333), dtype=torch.int32),
    }[which]
    _assert_exit_cull_exact(unit, rel, vdw, origin, order)


@pytest.mark.parametrize("dtype", DTYPES)
def test_exit_cull_exact_on_tangent_rays_and_padded_atoms(dtype):
    """Atoms placed tangent to chosen spiral rays (|perp| = r to rounding,
    and one ulp inside and outside), an atom containing the origin, and
    padded atoms at rel 0 with vdW 0, which the cull always drops."""
    p = 400
    pts = _spiral_rays(p, 1.0, dtype)
    unit = pts / torch.sqrt(sq_norm3(pts))[..., None]
    rng = np.random.default_rng(2)
    picks = rng.choice(p, 40, replace=False)
    atoms, radii = [], []
    u64 = unit[0].double().numpy()
    for j, k in enumerate(picks):
        u = u64[k]
        w = np.cross(u, rng.normal(size=3))
        w /= np.linalg.norm(w)
        r = rng.uniform(1.2, 1.8)
        t = rng.uniform(-9.0, 9.0)
        atoms.append(t * u + r * w)
        radii.append(r * (1.0 + (j % 3 - 1) * 1e-7))
    atoms.append([0.2, 0.1, -0.3])
    radii.append(1.5)
    n_real = len(atoms)
    rel = torch.tensor(np.concatenate([atoms, np.zeros((9, 3))])[None], dtype=dtype)
    vdw = torch.tensor(np.concatenate([radii, np.zeros(9)])[None], dtype=dtype)
    origin = torch.tensor([[0.4, -0.7, 0.2]], dtype=dtype)
    under = _kernel_under(unit, rel, vdw)
    near = (under.abs() <= 1e-5 * 9.0)[0, :, :n_real]
    assert int(near.sum()) >= 10, "too few rays are tangent to rounding"
    order = rays.spiral_tile_order(p, torch.device("cpu"))
    kept = _assert_exit_cull_exact(unit, rel, vdw, origin, order)
    keep = rk.ray_exit_keep(unit, rel, vdw, order)
    assert not bool(keep[..., n_real:].any())
    assert bool(keep[..., n_real - 1].all())  # the atom around the origin
    assert int(kept.max()) < n_real


@pytest.mark.parametrize("p", [1, 31, 33, 797, 947, 1040])
def test_spiral_tile_order_is_a_permutation(p):
    order = rays.spiral_tile_order(p, torch.device("cpu"))
    assert order.dtype == torch.int32 and order.shape == (p,)
    assert torch.equal(torch.sort(order.to(torch.int64)).values, torch.arange(p))


def test_spiral_tiles_are_compact():
    """The tiles of the 947-ray spiral are small caps: no ray lies more
    than 0.7 rad from its tile's mean direction (the identity order's
    tiles span the sphere)."""
    p = 947
    pts = _spiral_rays(p, 1.0, torch.float64)[0]
    for order, limit in ((rays.spiral_tile_order(p, torch.device("cpu")), 0.7), (torch.arange(p), None)):
        worst = 0.0
        for t in range(0, p, rk.RAY_TILE):
            u = pts[order[t : t + rk.RAY_TILE].to(torch.int64)]
            a = u.sum(0) / torch.linalg.norm(u.sum(0))
            worst = max(worst, float(torch.arccos(torch.clamp(u @ a, -1.0, 1.0)).max()))
        if limit is None:
            assert worst > 1.5
        else:
            assert worst < limit
