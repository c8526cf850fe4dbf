"""The ``clearance_min`` kernel's exact cull on the CPU, through its mirror
:func:`~pywindow_torch.ops.clearance_kernels.clearance_keep` (the
kernel's Morton orders, 32-atom tiles, seed tile and outward sweep, and
its skip rule in its own arithmetic): for every probe the minimum over
the pairs of the tiles its group keeps equals the plain version
(``torch.equal``, NaN where the plain version is NaN) in float32 and
float64, on the shapes of tests/test_pallas.py with the padding case, a
12^3 grid over the rebuilt periodic cell, and the adversarial sets of
``chip_smoke.clearance_cases`` (probes on atom centres and 1e3 Å
outside, NaN probe, atom and radius, N = 1, Q = 1, every atom padded but
one, Q = 1,000, far tiles a few ulps either side of the skip bound); for
any probe and atom order; and the rule's parts (the threshold, the box
gap, the keys, the tiles).  The port's plain version is held against the
JAX package's Pallas kernel in interpret mode on the grid.  The kernel
itself is held against the plain version on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import functools
import pathlib
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

import chip_smoke
from pywindow_torch.ops import clearance_kernels as ck
from pywindow_tpu.ops.pallas_kernels import clearance_min_pallas

DTYPES = [torch.float64, torch.float32]
CASES = [label for label, _ in chip_smoke.clearance_cases(torch.float64, "cpu", large=False)]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return chip_smoke.same_values(a, b)


@functools.cache
def _grid(dtype):
    return chip_smoke.periodic_grid(dtype, points=12, device="cpu")


def _pallas_sets(dtype):
    """The shapes and seeds of tests/test_pallas.py, and its padding case."""
    sets = []
    for q, n in ((100, 50), (1024, 256), (513, 129)):
        rng = np.random.default_rng(q + n)
        probes = rng.normal(size=(q, 3)) * 10
        sets.append((probes, rng.normal(size=(n, 3)) * 12, rng.uniform(1.0, 2.0, n)))
    rng = np.random.default_rng(3)
    coords = np.concatenate([rng.normal(size=(40, 3)) * 5, np.full((24, 3), 1.0e6)])
    vdw = np.concatenate([rng.uniform(1, 2, 40), np.zeros(24)])
    sets.append((rng.normal(size=(64, 3)) * 5, coords, vdw))
    return [tuple(torch.tensor(a, dtype=dtype) for a in s) for s in sets]


def _kept_minimum(args, cull, kept):
    """Per probe, the minimum of one distance matrix, computed once
    (``clearance_min_plain``'s own arithmetic), over the atoms of the
    tiles ``kept`` marks: (G, T) per group or (G, GROUP, T) per lane."""
    probes, coords, vdw = args
    q = probes.shape[0]
    d = probes[:, None, :] - coords[None]
    c = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]) - vdw
    tile = torch.empty_like(cull.atom_order)
    tile[cull.atom_order] = torch.arange(coords.shape[0]) // ck.TILE
    pos = torch.empty_like(cull.probe_order)
    pos[cull.probe_order] = torch.arange(q)
    rows = kept[pos // ck.GROUP] if kept.ndim == 2 else kept.reshape(-1, kept.shape[-1])[pos]
    return torch.where(rows[:, tile], c, torch.inf).amin(1)


def _assert_exact(args, **kwargs):
    """The mirror's minima, and the minima of one distance matrix over
    the tiles each group keeps, over those each lane's own test keeps and
    over those it keeps with its final minimum, all equal the plain
    version (the last three test the skip rule alone, apart from the
    mirror's own arithmetic)."""
    cull = ck.clearance_keep(*args, **kwargs)
    ref = ck.clearance_min_plain(*args)
    assert cull.best.dtype == ref.dtype
    assert _same(_kept_minimum(args, cull, cull.kept), ref)
    assert _same(_kept_minimum(args, cull, cull.lane_kept), ref)
    assert _same(_kept_minimum(args, cull, cull.needed), ref)
    assert bool((cull.lane_kept.any(1) <= cull.kept).all())
    assert bool((cull.needed <= cull.lane_kept).all())
    assert _same(cull.best, ref)
    return cull


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(4))
def test_cull_exact_on_pallas_shapes(dtype, case):
    cull = _assert_exact(_pallas_sets(dtype)[case])
    # the seed tile of every group is kept
    assert bool(cull.kept.any(1).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sort_probes", [True, False])
def test_cull_exact_on_periodic_grid(dtype, sort_probes):
    """12^3 probes over the rebuilt cell (1,344 atoms, 42 tiles), in the
    kernel's Morton order or grouped in the caller's order: exact, the
    cull skips most tile pairs (fewer in the sorted order), and a lane's
    own test keeps fewer pairs than its group visits, and fewer still
    with its final minimum."""
    args = _grid(dtype)
    caller = None if sort_probes else torch.arange(args[0].shape[0])
    cull = _assert_exact(args, probe_order=caller)
    share = float(cull.kept.double().mean())
    assert share < (0.5 if sort_probes else 0.7)
    assert int(cull.needed.sum()) < int(cull.lane_kept.sum()) < ck.GROUP * int(cull.kept.sum())
    if sort_probes:
        unsorted = ck.clearance_keep(*args, probe_order=torch.arange(args[0].shape[0]))
        assert int(cull.kept.sum()) < int(unsorted.kept.sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("label", CASES)
def test_cull_exact_on_adversarial_sets(dtype, label):
    args = dict(chip_smoke.clearance_cases(dtype, "cpu", large=False))[label]
    cull = _assert_exact(args)
    ref = ck.clearance_min_plain(*args)
    if label.startswith("NaN"):
        assert bool(torch.isnan(ref).any())
        assert torch.equal(torch.isnan(cull.best), torch.isnan(ref))


@pytest.mark.parametrize("dtype", DTYPES)
def test_skip_bound_is_where_the_rule_says(dtype):
    """The far tile of ``chip_smoke.clearance_bound_case`` is skipped
    exactly when its squared gap reaches the threshold, and the cases
    fall on both sides of it."""
    decisions = set()
    for k in chip_smoke.BOUND_GAP_ULPS:
        probes, coords, vdw = chip_smoke.clearance_bound_case(dtype, "cpu", k)
        cull = _assert_exact((probes, coords, vdw))
        # the seed is the near tile, the second tile holds the 32 far atoms
        assert bool((coords[cull.atom_order[ck.TILE :], 0] > 0).all())
        gap2 = coords[-1, 0] * coords[-1, 0]
        thr = ck.skip_threshold(torch.tensor(0.75, dtype=dtype), torch.tensor(1.5, dtype=dtype))
        skipped = not bool(cull.kept[0, 1])
        assert skipped == bool(gap2 >= thr)
        decisions.add(skipped)
    assert decisions == {True, False}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_exact_for_any_order(dtype, seed):
    """The rule does not rest on the sort: random probe and atom orders
    (the kernel's order within a cell may change from run to run) give
    the same minima."""
    g = torch.Generator().manual_seed(seed)
    for args in (_grid(dtype), _pallas_sets(dtype)[1], _pallas_sets(dtype)[3]):
        q, n = args[0].shape[0], args[1].shape[0]
        _assert_exact(args, probe_order=torch.randperm(q, generator=g),
                      atom_order=torch.randperm(n, generator=g))


@pytest.mark.parametrize("dtype", DTYPES)
def test_skip_threshold_bounds_the_exact_square(dtype):
    """T >= (best + R)^2 exactly where best + R > 0 (checked in rational
    arithmetic), 0 where best + R <= 0, NaN where no bound holds."""
    rng = np.random.default_rng(5)
    best = torch.tensor(np.concatenate([rng.uniform(-3, 6, 400), rng.uniform(0, 1e-30, 10)]), dtype=dtype)
    rmax = torch.tensor(np.concatenate([rng.uniform(0, 2.5, 400), np.zeros(10)]), dtype=dtype)
    thr = ck.skip_threshold(best, rmax)
    for b, r, t in zip(best.tolist(), rmax.tolist(), thr.tolist()):
        exact = Fraction(b) + Fraction(r)
        if exact <= 0:
            assert t == 0
        else:
            assert Fraction(t) >= exact * exact
    big = torch.finfo(dtype).max
    special = ck.skip_threshold(
        torch.tensor([torch.nan, torch.inf, big, 1.0], dtype=dtype),
        torch.tensor([1.0, 1.0, 0.0, torch.nan], dtype=dtype),
    )
    assert bool(torch.isnan(special).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_box_gap_is_below_every_pair(dtype):
    """The squared gap of a probe to a tile's box, rounded as the kernel
    rounds it, is at most the squared distance to every atom in the box,
    rounded as the pair is."""
    rng = np.random.default_rng(9)
    atoms = torch.tensor(rng.normal(size=(32, 3)) * 3, dtype=dtype)
    probes = torch.tensor(rng.normal(size=(500, 3)) * 8, dtype=dtype)
    lo, hi = atoms.amin(0), atoms.amax(0)
    gap2 = ck.box_gap2(probes, lo, hi)
    d = probes[:, None, :] - atoms[None]
    s = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    assert bool((gap2[:, None] <= s).all())
    assert bool((gap2 > 0).any()) and bool((gap2 == 0).any())


def test_keys_frame_and_tiles():
    """The frame leaves parked and non-finite atoms out, they take the far
    key after every cell, probe keys stay in [0, CELLS), and a tile with
    a non-finite coordinate or radius is flagged."""
    rng = np.random.default_rng(4)
    coords = np.concatenate([rng.normal(size=(40, 3)) * 5, np.full((56, 3), 1.0e6)])
    coords[3, 0] = np.nan
    vdw = np.concatenate([rng.uniform(1, 2, 40), np.zeros(56)])
    probes = torch.tensor(rng.normal(size=(70, 3)) * 8)
    c, v = torch.tensor(coords), torch.tensor(vdw)
    lo, scale = ck.clearance_frame(c)
    inner = c[:40][~torch.isnan(c[:40]).any(-1)]
    assert torch.equal(lo, inner.amin(0))
    assert float(scale) == ck.AXIS_CELLS / float((inner.amax(0) - inner.amin(0)).amax())
    pk, ak = ck.clearance_keys(probes, c)
    assert bool(((pk >= 0) & (pk < ck.CELLS)).all())
    assert bool((ak[40:] == 2 * ck.CELLS).all()) and int(ak[3]) == 2 * ck.CELLS
    assert bool((ak[:3] < 2 * ck.CELLS).all())
    probe_order, atom_order = ck.clearance_orders(probes, c)
    assert bool((pk[probe_order].diff() >= 0).all()) and bool((ak[atom_order].diff() >= 0).all())
    atoms = torch.cat([c[atom_order], v[atom_order, None]], -1)
    lo_t, rmax, hi_t, flag = ck.clearance_tiles(atoms)
    assert flag.tolist() == [False, True, False]  # the NaN atom sorts first among the far ones
    assert torch.equal(rmax[0], atoms[:32, 3].amax())
    assert torch.equal(lo_t[2], torch.full((3,), 1.0e6, dtype=torch.float64))


#: the mirror and the plain version as the first computation of a process
FIRST_CALL = """
import torch
import chip_smoke
from pywindow_torch.ops import clearance_kernels as ck
args = chip_smoke.periodic_grid(torch.float32, points=12, device="cpu")
cull = ck.clearance_keep(*args, probe_order=torch.arange(args[0].shape[0]))
print(chip_smoke.same_values(cull.best, ck.clearance_min_plain(*args)))
"""


def test_cull_exact_as_the_first_computation_of_a_process():
    """The mirror's first tile step is a fresh process's first
    multithreaded ``torch.sqrt``, which without
    ``config.warm_cpu_math`` returned one thread's share at reduced
    precision in some processes: two fresh processes each hold the
    mirror's minima equal to the plain version."""
    root = pathlib.Path(__file__).resolve().parents[1]
    runs = [
        subprocess.Popen([sys.executable, "-c", FIRST_CALL], cwd=root, stdout=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [run.communicate(timeout=300)[0].split()[-1:] for run in runs]
    assert outs == [["True"], ["True"]]


def test_plain_matches_pallas_on_periodic_grid():
    """The port's plain version against the JAX kernel in interpret mode
    on the 12^3 grid, at 1e-10 Å in float64."""
    probes, coords, vdw = _grid(torch.float64)
    ref = np.asarray(
        clearance_min_pallas(probes.numpy(), coords.numpy(), vdw.numpy(), interpret=True)
    )
    got = ck.clearance_min(probes, coords, vdw)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10, rtol=0)
