"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc``; they carry the ``cuda``
marker and skip from the ``cuda`` fixture without a card.  They import
neither JAX nor the test conftest's helpers, so on the card's machine
(which has no JAX) they run as
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.

Tolerances: ``ray_exit`` rounds like its plain version in float64
(flags equal, distances within 1e-9 Å; float32 within 1e-4 Å, with a few
grazing rays allowed to flip); ``path_sweep``, ``fine_path`` and
``dbscan`` equal their plain versions bit for bit in both dtypes, so
does ``clearance_min`` (NaN where the plain version is NaN), so does
``max_dim`` in both forms, its atoms included (NaN where the plain
version is NaN), and
``ray_exit`` equals, bit for bit,
its own pair arithmetic over every atom (what the kernel computed before
its cull), whatever order groups its rays; the optimiser kernels run
float64 and stop where the plain drivers stop: x within 1e-6 Å and the
same ``capped`` flag on every lane, or, on a flat ridge, objective
values within 1e-9.
"""

import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
import pywindow_torch as pt
from pywindow_torch.ops import (
    _cuda,
    clearance_kernels,
    cluster,
    cluster_kernels,
    geometry,
    lbfgsb_kernels,
    nm_kernels,
    pair_kernels,
    ray_kernels,
    rays,
)
from pywindow_torch.ops.encoding import MolArrays

DATA = pathlib.Path(__file__).parent / "data"
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mol(n, seed, dtype, device, pad=8, frames=None):
    """Random molecule(s): (N_pad, 3) or, with ``frames``, (B, N_pad, 3)
    with the padded atoms parked at 1e6 with vdW 0."""
    rng = np.random.default_rng(seed)
    b = frames or 1
    n_pad = ((n + pad - 1) // pad) * pad
    coords = np.full((b, n_pad, 3), 1.0e6)
    coords[:, :n] = rng.normal(size=(b, n, 3)) * 6
    vdw = np.zeros((b, n_pad))
    vdw[:, :n] = rng.uniform(1.2, 2.0, (b, n))
    mask = np.broadcast_to(np.arange(n_pad) < n, (b, n_pad)).copy()
    if frames is None:
        coords, vdw, mask = coords[0], vdw[0], mask[0]

    def f(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return MolArrays(f(coords), f(vdw), f(vdw), f(vdw), torch.tensor(mask, device=device))


def _cages(b, seed, device, n=96, pad=104):
    """Hollow random shells (a pore at the centre), float64, (B, N_pad)."""
    rng = np.random.default_rng(seed)
    coords = np.full((b, pad, 3), 1.0e6)
    vdw = np.zeros((b, pad))
    for i in range(b):
        pts = rng.normal(size=(n, 3))
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        coords[i, :n] = pts * rng.uniform(5.0, 8.0) + rng.normal(scale=0.3, size=(n, 3))
        vdw[i, :n] = rng.uniform(1.2, 1.8, n)
    return (
        torch.tensor(coords, dtype=torch.float64, device=device),
        torch.tensor(vdw, dtype=torch.float64, device=device),
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("want_exit", [True, False])
def test_ray_exit_kernel_matches_plain(cuda, dtype, want_exit):
    mol = _mol(150, 1, dtype, cuda, frames=3)
    radius = torch.tensor([14.0, 12.5, 15.0], dtype=dtype, device=cuda)
    pts = rays.golden_spiral(700, radius)
    unit, rel, origin = rays._ray_frame(pts, mol)
    before = _cuda.LAUNCHES["ray_exit"]
    hk, ek = ray_kernels.ray_exit(unit, rel, mol.vdw, origin, want_exit, rays.spiral_tile_order(700, cuda))
    assert _cuda.LAUNCHES["ray_exit"] == before + 1
    hp, ep = ray_kernels.ray_exit_plain(unit, rel, mol.vdw, origin, want_exit)
    torch.cuda.synchronize()
    agree = hk == hp
    if dtype == torch.float64:
        assert bool(agree.all())
    else:
        assert int((~agree).sum()) <= 0.005 * hk.numel()
    both = hk & hp
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    if want_exit:
        assert float((ek - ep)[both].abs().max()) <= tol
    else:
        assert bool((ek == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_path_sweep_kernel_matches_plain(cuda, dtype):
    mol = _mol(168, 2, dtype, cuda, frames=3)
    radius = torch.tensor([11.0, 10.3, 12.2], dtype=dtype, device=cuda)
    vectors = rays.golden_spiral(383, radius)
    _, chunks = rays._chunks(vectors, 1.0)
    before = _cuda.LAUNCHES["path_sweep"]
    ok_k, pos_k, c_k = ray_kernels.path_sweep(vectors, chunks, mol.coords, mol.vdw, 16)
    assert _cuda.LAUNCHES["path_sweep"] == before + 1
    ok_p, pos_p, c_p = ray_kernels.path_sweep_plain(vectors, chunks, mol.coords, mol.vdw, 16)
    assert torch.equal(ok_k, ok_p) and torch.equal(pos_k, pos_p)
    assert torch.equal(c_k, c_p)  # bit for bit: the cull keeps every deciding atom


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_active", [False, True])
def test_fine_path_kernel_matches_plain(cuda, dtype, with_active):
    """B = 5 frames of W = 8 rays, 150 atoms padded to 152, 120 fine steps,
    equal to the plain version bit for bit; with ``active``, the inactive
    slots (a whole frame of them among others) hold the placeholders on
    both sides."""
    mol = _mol(150, 4, dtype, cuda, frames=5)
    rng = np.random.default_rng(4)
    vec = rng.normal(size=(5, 8, 3))
    vec = vec / np.linalg.norm(vec, axis=-1, keepdims=True) * rng.uniform(6, 11, (5, 8, 1))
    vectors = torch.tensor(vec, dtype=dtype, device=cuda)
    _, chunks = rays._chunks(vectors, 0.1)
    active = None
    if with_active:
        active = torch.tensor(rng.random((5, 8)) > 0.5, device=cuda)
        active[2] = False
    before = _cuda.LAUNCHES["fine_path"]
    got = ray_kernels.fine_path(vectors, chunks, mol.coords, mol.vdw, 120, active)
    assert _cuda.LAUNCHES["fine_path"] == before + 1
    want = ray_kernels.fine_path_plain(vectors, chunks, mol.coords, mol.vdw, 120, active)
    torch.cuda.synchronize()
    assert _equal(got, want)
    if with_active:
        assert not bool(got[0][~active].any()) and bool((got[2][~active] == 1e30).all())


def _dbscan_plain(points, valid, eps, min_samples, max_clusters):
    """The plain (labels, n_clusters), 64 frames at a time (its
    (B, K, K, 3) differences would not fit at B = 1,440)."""
    parts = [
        cluster.dbscan(points[lo : lo + 64], valid[lo : lo + 64], eps[lo : lo + 64], min_samples, max_clusters)
        for lo in range(0, points.shape[0], 64)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _dbscan_sets(b, k, seed, dtype, device):
    """B clumpy point sets of K slots (5 blobs and noise, ~10% invalid)."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(b, 5, 3)) * 5
    pts = np.concatenate(
        [(centres[:, i : i + 1] + rng.normal(scale=0.4, size=(b, k // 5, 3))) for i in range(5)]
        + [rng.normal(scale=6, size=(b, k - 5 * (k // 5), 3))], 1,
    )
    points = torch.tensor(pts, dtype=dtype, device=device)
    valid = torch.tensor(rng.random((b, k)) > 0.1, device=device)
    eps = torch.tensor(rng.uniform(0.8, 1.2, b), dtype=dtype, device=device)
    return points, valid, eps


def _dbscan_k(k, dtype):
    """K of a case: a number, the stored route's largest K and the one
    after it, or the shared route's largest K and the one after it (the
    first K whose frame lives in global memory)."""
    size = torch.empty((), dtype=dtype).element_size()
    last = {}
    for j in range(32, 12000):
        last[cluster_kernels.dbscan_route(j, size)] = j
    if k == "stored_max":
        return last["stored"]
    if k == "stored_max+1":
        return last["stored"] + 1
    if k == "largest":
        return last["shared"]
    if k == "largest+1":
        return last["shared"] + 1
    return int(k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    ("b", "k"),
    [
        (1, "384"), (8, "384"), (1440, "384"), (2, "1000"), (1, "stored_max"), (1, "stored_max+1"),
        (1, "largest"), (2, "largest+1"), (1, "12000"),
    ],
)
def test_dbscan_kernel_matches_plain(cuda, dtype, b, k):
    """Label for label at B = 1, 8 and 1,440 frames, K = 384 and 1,000,
    at the last K whose eps-graph the block stores, the first it tests
    anew, the last whose frame fits shared memory, the first kept in
    global memory and K = 12,000; n_clusters too."""
    k = _dbscan_k(k, dtype)
    points, valid, eps = _dbscan_sets(b, k, k + b, dtype, cuda)
    before = _cuda.LAUNCHES["dbscan"]
    labels_k, n_k = cluster_kernels.dbscan(points, valid, eps, 5, 4)
    assert _cuda.LAUNCHES["dbscan"] == before + 1
    labels_p, n_p = _dbscan_plain(points, valid, eps, 5, 4)
    torch.cuda.synchronize()
    assert torch.equal(labels_k, labels_p)
    assert torch.equal(n_k.cpu(), n_p.cpu())
    assert int(labels_p.max()) >= 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dbscan_kernel_on_a_chain_and_at_any_width(cuda, dtype, monkeypatch):
    """A 300-point chain (graph diameter 299) among noise in each of 3
    frames, at 128, 256, 512 and 1,024 threads a frame: the plain
    version's labels every time."""
    rng = np.random.default_rng(21)
    sets = []
    for f in range(3):
        chain = np.stack([np.arange(300) * 0.45, 0.05 * np.sin(np.arange(300) + f), np.zeros(300)], -1)
        noise = rng.uniform(-40.0, 40.0, (84, 3)) + np.array([0.0, 0.0, 60.0])
        sets.append(np.concatenate([chain, noise])[rng.permutation(384)])
    points = torch.tensor(np.stack(sets), dtype=dtype, device=cuda)
    valid = torch.tensor(rng.random((3, 384)) > 0.02, device=cuda)
    eps = torch.full((3,), 0.5, dtype=dtype, device=cuda)
    want = _dbscan_plain(points, valid, eps, 3, 8)[0]
    for width in (128, 256, 512, 1024):
        monkeypatch.setattr(cluster_kernels, "dbscan_threads", lambda f, s, w=width: w)
        got = cluster_kernels.dbscan_labels_cuda(points, valid, eps, 3, 8)
        torch.cuda.synchronize()
        assert torch.equal(got, want), width


def test_dbscan_kernel_at_exact_eps_ties(cuda):
    """float32 pairs (0, v) at eps = sqrt(|v|^2) on the card, where
    fl(eps * eps) < |v|^2: the kernel's sqrt(d^2) <= eps keeps them, as
    the plain version does."""
    rng = np.random.default_rng(11)
    v = rng.uniform(-1.0, 1.0, (4000, 3)).astype(np.float32)
    d2 = (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
    s = np.sqrt(d2)
    tie = (d2 > s * s) & (s > 0.5)
    v, s = v[tie][:64], s[tie][:64]
    pts = np.zeros((64, 12, 3), dtype=np.float32)
    pts[:, 1] = v
    pts[:, 2] = v
    pts[:, 3] = 2 * v
    pts[:, 4:] = rng.uniform(20.0, 40.0, (64, 8, 3)).astype(np.float32)
    points = torch.tensor(pts, device=cuda)
    valid = torch.ones((64, 12), dtype=torch.bool, device=cuda)
    eps = torch.tensor(s, device=cuda)
    for min_samples in (2, 3):
        got = cluster_kernels.dbscan_labels_cuda(points, valid, eps, min_samples, 8)
        want = cluster.dbscan(points, valid, eps, min_samples, 8)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert bool((got[:, :4] == 0).all())


def _assert_optimiser_lanes(x_k, f_k, cap_k, x_p, f_p, cap_p):
    assert torch.equal(cap_k, cap_p)
    dx = (x_k - x_p).abs().amax(-1)
    off = dx > 1e-6
    assert bool(((f_k - f_p).abs()[off] <= 1e-9).all()), (dx[off], (f_k - f_p)[off])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(("q", "n"), [(100, 50), (513, 129), (4100, 1344)])
def test_clearance_min_kernel_matches_plain(cuda, dtype, q, n):
    """Exact in both dtypes: the same difference-form distances, rounded
    op by op (-fmad=false), and a minimum that is exact in any order;
    24 parked atoms (1e6, vdW 0) never win."""
    rng = np.random.default_rng(q + n)
    coords = np.concatenate([rng.normal(size=(n, 3)) * 12, np.full((24, 3), 1.0e6)])
    vdw = np.concatenate([rng.uniform(1.0, 2.0, n), np.zeros(24)])
    probes = rng.normal(size=(q, 3)) * 10

    def f(a):
        return torch.tensor(a, dtype=dtype, device=cuda)

    before = _cuda.LAUNCHES["clearance_min"]
    got = clearance_kernels.clearance_min(f(probes), f(coords), f(vdw))
    assert _cuda.LAUNCHES["clearance_min"] == before + 1
    ref = clearance_kernels.clearance_min_plain(f(probes), f(coords), f(vdw))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (q,)
    assert torch.equal(got, ref)


def _same(a, b):
    """torch.equal, with NaN equal to NaN in the same place."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _clearance_plain_sliced(probes, coords, vdw):
    # the plain version holds (Q, N, 3) differences: 1,024 probes a slice
    return torch.cat([
        clearance_kernels.clearance_min_plain(probes[lo : lo + 1024], coords, vdw)
        for lo in range(0, probes.shape[0], 1024)
    ])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_clearance_min_cull_equals_plain_on_adversarial_sets(cuda, dtype):
    """The exact cull changes nothing, to the bit, on
    chip_smoke.clearance_cases: probes on atom centres and
    1e3 Å outside, NaN probe, atom and radius (NaN where the plain version
    is), N = 1, Q = 1, every atom padded but one, Q = 1,000 (not a
    multiple of the 32-probe group), far tiles a few ulps either side of
    the skip bound, N = 20,000 (625 tiles).  One sweep launch a call, and
    one of each helper pass."""
    import chip_smoke

    for label, args in chip_smoke.clearance_cases(dtype, cuda):
        before = dict(_cuda.LAUNCHES)
        got = clearance_kernels.clearance_min(*args)
        for key in ("clearance_min",) + clearance_kernels.HELPER_KERNELS:
            assert _cuda.LAUNCHES[key] == before.get(key, 0) + 1, (label, key)
        ref = _clearance_plain_sliced(*args)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == ref.shape, label
        assert _same(got, ref), label


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_clearance_min_sort_and_tiles_match_the_mirror(cuda, dtype):
    """The kernel's passes on the 12^3 periodic grid: its probe and atom
    orders are permutations sorted by the mirror's keys
    (clearance_kernels.clearance_keys), and its tiles equal the mirror's
    (clearance_tiles) for its atom order; the mirror's minima over the
    tiles it keeps under the kernel's orders equal the kernel's output."""
    import chip_smoke

    probes, coords, vdw = chip_smoke.periodic_grid(dtype, points=12, device=cuda)
    q, n = probes.shape[0], coords.shape[0]
    out, work = clearance_kernels.clearance_min_launch(probes, coords, vdw)
    torch.cuda.synchronize()
    probe_order, atom_order = work.order[:q].long(), work.order[q:].long()
    assert torch.equal(probe_order.sort().values, torch.arange(q, device=cuda))
    assert torch.equal(atom_order.sort().values, torch.arange(n, device=cuda))
    pk, ak = clearance_kernels.clearance_keys(probes, coords)
    assert bool((pk[probe_order].diff() >= 0).all()) and bool((ak[atom_order].diff() >= 0).all())
    assert torch.equal(work.sorted_probes, probes[probe_order])
    atoms = torch.cat([coords[atom_order], vdw[atom_order, None]], -1)
    assert torch.equal(work.sorted_atoms, atoms)
    lo, rmax, hi, flag = clearance_kernels.clearance_tiles(atoms)
    tiles = torch.cat([lo, rmax[:, None], hi, flag[:, None].to(dtype)], -1)
    assert torch.equal(work.tiles, tiles)
    cull = clearance_kernels.clearance_keep(
        probes, coords, vdw, probe_order=probe_order, atom_order=atom_order
    )
    assert torch.equal(cull.best, out)
    assert torch.equal(out, clearance_kernels.clearance_min_plain(probes, coords, vdw))


def test_lbfgsb_stable_kernel_matches_plain_pore_lanes(cuda):
    """d = 3: 13 pore-centre lanes (not a multiple of a warp's 32),
    104-slot padded shells, from the COM within ±pore_r."""
    coords, vdw = _cages(13, 5, cuda)
    mask = vdw > 0
    w = mask.double()
    com = (coords * w[..., None]).sum(1) / w.sum(1, keepdim=True)
    d = torch.sqrt(((coords - com[:, None]) ** 2).sum(-1)) - vdw
    r = torch.where(mask, d, 1e30).amin(-1)[:, None]
    args = (coords, vdw, torch.zeros_like(com), com, com - r, com + r)
    kw = dict(emb=lbfgsb_kernels.EMB_XYZ, sign=-1.0, maxiter=40)
    before = _cuda.LAUNCHES["lbfgsb_stable"]
    x_k, f_k, _, _, cap_k = lbfgsb_kernels.lbfgsb_stable_flat(*args, **kw)
    assert _cuda.LAUNCHES["lbfgsb_stable"] == before + 1
    x_p, f_p, _, _, cap_p = lbfgsb_kernels.lbfgsb_stable_flat_plain(*args, **kw)
    torch.cuda.synchronize()
    _assert_optimiser_lanes(x_k, f_k, cap_k, x_p, f_p, cap_p)


def test_lbfgsb_stable_kernel_matches_plain_z_lanes(cuda):
    """d = 1: window-z lanes with the z-axis embedding, a lower bound and
    an 'infinite' upper one."""
    coords, vdw = _cages(9, 6, cuda)
    rng = np.random.default_rng(6)
    xy = torch.tensor(rng.normal(scale=0.5, size=(9, 2)), dtype=torch.float64, device=cuda)
    origin = torch.cat([xy, torch.zeros_like(xy[:, :1])], -1)
    x0 = torch.zeros((9, 1), dtype=torch.float64, device=cuda)
    lo = torch.tensor(-rng.uniform(1, 4, (9, 1)), dtype=torch.float64, device=cuda)
    up = torch.full_like(lo, 1e10)
    kw = dict(emb=lbfgsb_kernels.EMB_Z, sign=1.0, maxiter=40)
    x_k, f_k, _, _, cap_k = lbfgsb_kernels.lbfgsb_stable_flat_cuda(coords, vdw, origin, x0, lo, up, **kw)
    x_p, f_p, _, _, cap_p = lbfgsb_kernels.lbfgsb_stable_flat_plain(coords, vdw, origin, x0, lo, up, **kw)
    torch.cuda.synchronize()
    _assert_optimiser_lanes(x_k, f_k, cap_k, x_p, f_p, cap_p)


def test_nm_xy_kernel_matches_plain(cuda):
    """11 (frame, window) lanes of padded shells, the 20 x 20 grid and
    the polish, with a fast budget that caps some lanes."""
    coords, vdw = _cages(11, 7, cuda)
    rng = np.random.default_rng(7)
    z = torch.tensor(rng.normal(scale=0.5, size=11), dtype=torch.float64, device=cuda)
    half = torch.tensor(rng.uniform(1.0, 3.0, 11), dtype=torch.float64, device=cuda)
    for maxiter in (400, 6):
        before = _cuda.LAUNCHES["nm_xy"]
        xy_k, f_k, cap_k = nm_kernels.nm_xy_flat(coords, vdw, z, half, brute_ns=20, maxiter=maxiter)
        assert _cuda.LAUNCHES["nm_xy"] == before + 1
        xy_p, f_p, cap_p = nm_kernels.nm_xy_flat_plain(coords, vdw, z, half, brute_ns=20, maxiter=maxiter)
        torch.cuda.synchronize()
        _assert_optimiser_lanes(xy_k, f_k, cap_k, xy_p, f_p, cap_p)


def test_wrappers_raise_on_bad_inputs(cuda):
    x = torch.zeros((1, 10, 3), dtype=torch.float32, device=cuda)
    order = torch.arange(10, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        ray_kernels.ray_exit_cuda(x, x.double(), x[..., 0], x[:, 0], True, order)
    with pytest.raises(TypeError, match="int32"):
        ray_kernels.ray_exit_cuda(x, x, x[..., 0].contiguous(), x[:, 0].contiguous(), True, order.long())
    strided = torch.zeros((1, 3, 10), dtype=torch.float32, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ray_kernels.ray_exit_cuda(strided, x, x[..., 0].contiguous(), x[:, 0].contiguous(), True, order)
    coords = torch.zeros((2, 10, 3), dtype=torch.float64, device=cuda)
    vdw = torch.ones((2, 10), dtype=torch.float64, device=cuda)
    x3 = torch.zeros((2, 3), dtype=torch.float64, device=cuda)
    x1 = torch.zeros((2, 1), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float64"):
        lbfgsb_kernels.lbfgsb_stable_flat_cuda(
            coords.float(), vdw.float(), x3.float(), x3.float(), x3.float(), x3.float()
        )
    with pytest.raises(ValueError, match="embedding"):
        lbfgsb_kernels.lbfgsb_stable_flat_cuda(
            coords, vdw, x3, x1, x1, x1, emb=lbfgsb_kernels.EMB_XYZ
        )
    with pytest.raises(ValueError, match="shape"):
        nm_kernels.nm_xy_flat_cuda(coords, vdw, x1[:1, 0].contiguous(), x1[:, 0].contiguous())
    with pytest.raises(TypeError, match="float64"):
        clearance_kernels.clearance_min_cuda(x3, coords[0].float(), vdw[0])
    with pytest.raises(ValueError, match="shape"):
        clearance_kernels.clearance_min_cuda(x3, coords[0], vdw)
    with pytest.raises(ValueError, match="one CUDA device"):
        clearance_kernels.clearance_min_cuda(x3, coords[0].cpu(), vdw[0])
    mask = torch.ones((2, 10), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        pair_kernels.max_dim_cuda(coords.float(), vdw, mask, True)
    with pytest.raises(TypeError, match="bool"):
        pair_kernels.max_dim_cuda(coords, vdw, mask.to(torch.uint8), True)
    with pytest.raises(ValueError, match="shape"):
        pair_kernels.max_dim_cuda(coords, vdw[:, :9].contiguous(), mask, False)
    with pytest.raises(ValueError, match="contiguous"):
        pair_kernels.max_dim_cuda(coords.transpose(0, 1), vdw, mask, True)


def _max_dim_frames(b, n, seed, dtype, device):
    """B seeded frames of N slots: the last N // 16 parked at 1e6 with
    vdW 0 and masked, and, with B > 1, frame 1 masked whole."""
    rng = np.random.default_rng(seed)
    valid = n - n // 16
    coords = np.full((b, n, 3), 1.0e6)
    coords[:, :valid] = rng.normal(size=(b, valid, 3)) * 6
    vdw = np.zeros((b, n))
    vdw[:, :valid] = rng.uniform(1.2, 2.0, (b, valid))
    mask = np.broadcast_to(np.arange(n) < valid, (b, n)).copy()
    if b > 1:
        mask[1] = False
    return (
        torch.tensor(coords, dtype=dtype, device=device),
        torch.tensor(vdw, dtype=dtype, device=device),
        torch.tensor(mask, device=device),
    )


def _assert_max_dim_kernel_exact(coords, vdw, mask):
    for atoms in (True, False):
        before = (_cuda.LAUNCHES["max_dim"], _cuda.LAUNCHES["max_dim_reduce"])
        got = pair_kernels.max_dim_cuda(coords, vdw, mask, atoms)
        assert (_cuda.LAUNCHES["max_dim"], _cuda.LAUNCHES["max_dim_reduce"]) == (
            before[0] + 1, before[1] + 1,
        )
        ref = pair_kernels.max_dim_flat_plain(coords, vdw, mask, atoms)
        torch.cuda.synchronize()
        assert len(got) == len(ref) == (3 if atoms else 1)
        for g, r in zip(got, ref):
            assert chip_smoke.same_values(g, r), atoms


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "b,n", [(1, 168), (96, 168), (4320, 168), (1200, 424), (3, 1), (5, 301)]
)
def test_max_dim_kernel_matches_plain(cuda, dtype, b, n):
    """Both forms on the sweep chunks' shapes, a single molecule, N = 1
    and an N that is no multiple of 8 or of the tile."""
    _assert_max_dim_kernel_exact(*_max_dim_frames(b, n, b + n, dtype, cuda))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_max_dim_kernel_on_adversarial_frames(cuda, dtype):
    """``chip_smoke.max_dim_cases``: ties across tiles and in one, the
    two orders of the value form, all masked, sums below -1e30, NaN
    coordinates, N = 1, N = 301 padded."""
    for label, args in chip_smoke.max_dim_cases(dtype, cuda):
        _assert_max_dim_kernel_exact(*args)


def test_max_dim_entry_points_on_the_card(cuda):
    """``geometry.max_dim`` and ``max_dim_value`` on the card launch the
    kernel and keep the leading axes: one molecule without a frame axis,
    and frames under two leading axes."""
    coords, vdw, mask = _max_dim_frames(6, 168, 9, torch.float32, cuda)
    for shape in ((168,), (2, 3, 168)):
        sel = slice(0, 1) if len(shape) == 1 else slice(None)
        mol = MolArrays(*(t[sel].reshape(*shape, *t.shape[2:]) for t in (coords, vdw, vdw, vdw, mask)))
        before = _cuda.LAUNCHES["max_dim"]
        got = geometry.max_dim(mol)
        value = geometry.max_dim_value(mol)
        assert _cuda.LAUNCHES["max_dim"] == before + 2
        ref = pair_kernels.max_dim_plain(mol)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        assert torch.equal(value, pair_kernels.max_dim_value_plain(mol))
        assert value.shape == shape[:-1]


def test_full_analysis_on_the_card_matches_cpu_float32(cuda, monkeypatch):
    """The single-molecule path end to end on the card against the same
    configuration (float32 pipeline, float64 stable optimisers) on the
    CPU, and every kernel launched on the way."""
    path = DATA / "PUDXES.xyz"
    mol = pt.MolecularSystem.load_file(path).system_to_molecule()
    _cuda.LAUNCHES.clear()
    gpu = mol.full_analysis()  # the card is the default device
    for key in ("ray_exit", "path_sweep", "dbscan", "fine_path", "lbfgsb_stable", "nm_xy", "max_dim"):
        assert _cuda.LAUNCHES[key] > 0, key
    monkeypatch.setenv("PYWINDOW_TORCH_FORCE_F32", "1")
    cpu = pt.MolecularSystem.load_file(path).system_to_molecule().full_analysis(device="cpu")
    for key in ("pore_diameter", "pore_diameter_opt", "maximum_diameter"):
        assert abs(gpu[key]["diameter"] - cpu[key]["diameter"]) < 1e-3
    np.testing.assert_allclose(
        np.sort(gpu["windows"]["diameters"]), np.sort(cpu["windows"]["diameters"]), atol=1e-3
    )


def test_batched_launches_do_not_depend_on_batch_size(cuda):
    """analyze_batch runs each kernel the same number of times for 2
    frames as for 9 (max_dim three times a pipeline call, with its
    helper pass), and every frame equals its own B = 1 run."""
    from pywindow_torch.parallel import batch

    elements, coords = _pudxes()
    counts = []
    for n_frames in (2, 9):
        _cuda.LAUNCHES.clear()
        handle = batch.dispatch_batch(
            [(elements, coords)] * n_frames, reference_max_diameter=22.179369990077188
        )
        res = batch.collect_batch(handle)
        counts.append(dict(_cuda.LAUNCHES))
    assert counts[0] == counts[1]
    assert counts[0]["max_dim"] == counts[1]["max_dim"] == counts[0]["max_dim_reduce"]
    assert counts[0]["max_dim"] == 3 * counts[0]["path_sweep"] > 0
    one = batch.collect_batch(
        batch.dispatch_batch([(elements, coords)], reference_max_diameter=22.179369990077188)
    )[0]
    for r in res:
        assert r["pore_diameter_opt"]["diameter"] == pytest.approx(
            one["pore_diameter_opt"]["diameter"], abs=1e-6
        )


def _pudxes():
    lines = (DATA / "PUDXES.xyz").read_text().splitlines()[2:]
    body = [ln.split() for ln in lines if ln.strip()]
    return np.array([b[0] for b in body]), np.array([[float(v) for v in b[1:4]] for b in body])


# -- the redesigned optimiser kernels: active lanes, waves, ties ------------


def _window_lanes(coords, vdw, seed, device):
    """Window-z / window-xy lane inputs for padded shells: xy offsets,
    z anchors, grid half-widths, z bounds."""
    rng = np.random.default_rng(seed)
    lanes = coords.shape[0]

    def f(a):
        return torch.tensor(a, dtype=torch.float64, device=device)

    xy = f(rng.normal(scale=0.5, size=(lanes, 2)))
    origin = torch.cat([xy, torch.zeros_like(xy[:, :1])], -1)
    lo = f(-rng.uniform(1, 4, (lanes, 1)))
    return {
        "origin": origin,
        "x0": torch.zeros((lanes, 1), dtype=torch.float64, device=device),
        "lo": lo,
        "up": torch.full_like(lo, 1e10),
        "z": f(rng.normal(scale=0.5, size=lanes)),
        "half": f(rng.uniform(1.0, 3.0, lanes)),
    }


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def test_inactive_lanes_do_no_work_and_leave_the_active_ones_alone(cuda):
    """d = 1 lbfgsb_stable and nm_xy with every other lane inactive (and a
    run of three): the active lanes equal a run without the flag to the
    bit, the inactive ones hold the placeholders, and the plain versions
    agree within the optimisers' tolerance (synthetic shells; the real
    window lanes are held with torch.equal below)."""
    coords, vdw = _cages(12, 8, cuda)
    w = _window_lanes(coords, vdw, 8, cuda)
    active = torch.tensor([True, False] * 4 + [False, False, False, True], device=cuda)
    kw = dict(emb=lbfgsb_kernels.EMB_Z, sign=1.0, maxiter=40)
    args = (coords, vdw, w["origin"], w["x0"], w["lo"], w["up"])
    full = lbfgsb_kernels.lbfgsb_stable_flat_cuda(*args, **kw)
    part = lbfgsb_kernels.lbfgsb_stable_flat_cuda(*args, active=active, **kw)
    plain = lbfgsb_kernels.lbfgsb_stable_flat_plain(*args, active=active, **kw)
    torch.cuda.synchronize()
    assert _equal([p[active] for p in part], [f[active] for f in full])
    assert torch.equal(part[0][~active], w["x0"][~active])
    assert not bool(part[2][~active].any()) and not bool(part[4][~active].any())
    _assert_optimiser_lanes(part[0], part[1], part[4], plain[0], plain[1], plain[4])
    nm_args = (coords, vdw, w["z"], w["half"])
    full = nm_kernels.nm_xy_flat_cuda(*nm_args, maxiter=400)
    part = nm_kernels.nm_xy_flat_cuda(*nm_args, active=active, maxiter=400)
    plain = nm_kernels.nm_xy_flat_plain(*nm_args, active=active, maxiter=400)
    torch.cuda.synchronize()
    assert _equal([p[active] for p in part], [f[active] for f in full])
    assert not bool(part[0][~active].any()) and not bool(part[2][~active].any())
    _assert_optimiser_lanes(*part, *plain)


@pytest.mark.parametrize("threads", [64, 128])
def test_nm_xy_kernel_more_than_one_wave(cuda, monkeypatch, threads):
    """5,120 lanes (several waves at either block width): each lane
    equals the same lane run alone, and the plain version within the
    optimisers' tolerance (on these synthetic shells the plain version's
    f may differ from the kernel's in the last bits)."""
    base, vdw = _cages(16, 9, cuda)
    coords = base.repeat(320, 1, 1).contiguous()
    vdw = vdw.repeat(320, 1).contiguous()
    w = _window_lanes(coords, vdw, 9, cuda)
    monkeypatch.setattr(nm_kernels, "lane_threads", lambda lanes, n, sms: threads)
    got = nm_kernels.nm_xy_flat_cuda(coords, vdw, w["z"], w["half"], maxiter=400)
    for i in (0, 1777, 5119):
        one = nm_kernels.nm_xy_flat_cuda(
            coords[i : i + 1], vdw[i : i + 1], w["z"][i : i + 1], w["half"][i : i + 1], maxiter=400
        )
        assert _equal([g[i : i + 1] for g in got], one)
    want = nm_kernels.nm_xy_flat_plain(coords, vdw, w["z"], w["half"], maxiter=400)
    torch.cuda.synchronize()
    _assert_optimiser_lanes(*got, *want)


@pytest.mark.parametrize("threads", [32, 64, 128, 256])
def test_optimiser_kernels_reymal_size_lanes(cuda, monkeypatch, threads):
    """N = 468 atoms padded to 472 (REYMAL's size): more atoms than the
    registers of 32-128 threads hold, at every block width."""
    coords, vdw = _cages(6, 10, cuda, n=468, pad=472)
    monkeypatch.setattr(lbfgsb_kernels, "lane_launch", lambda lanes, n, sms: (threads, False))
    monkeypatch.setattr(nm_kernels, "lane_threads", lambda lanes, n, sms: threads)
    mask = vdw > 0
    wt = mask.double()
    com = (coords * wt[..., None]).sum(1) / wt.sum(1, keepdim=True)
    d = torch.sqrt(((coords - com[:, None]) ** 2).sum(-1)) - vdw
    r = torch.where(mask, d, 1e30).amin(-1)[:, None]
    args = (coords, vdw, torch.zeros_like(com), com, com - r, com + r)
    kw = dict(emb=lbfgsb_kernels.EMB_XYZ, sign=-1.0, maxiter=40)
    got = lbfgsb_kernels.lbfgsb_stable_flat_cuda(*args, **kw)
    want = lbfgsb_kernels.lbfgsb_stable_flat_plain(*args, **kw)
    _assert_optimiser_lanes(got[0], got[1], got[4], want[0], want[1], want[4])
    w = _window_lanes(coords, vdw, 10, cuda)
    nm_args = (coords, vdw, w["z"], w["half"])
    _assert_optimiser_lanes(*nm_kernels.nm_xy_flat_cuda(*nm_args), *nm_kernels.nm_xy_flat_plain(*nm_args))


@pytest.mark.parametrize("ns", [3, 5])
def test_nm_xy_grid_ties_take_the_first_minimum(cuda, ns):
    """A molecule symmetric under x -> -x and y -> -y, so that mirrored
    grid points tie exactly (the grid values of ns = 3 and 5 are exact),
    with an atom on the axis so that the best points lie off it: the
    kernel starts the polish from the same first minimum as the plain
    version, and ends where it ends."""
    rng = np.random.default_rng(ns)
    quarter = np.abs(rng.normal(scale=4.0, size=(10, 3))) + [0.5, 0.5, 0.0]
    quarter[:, 2] = rng.normal(scale=3.0, size=10)
    atoms = np.concatenate(
        [quarter * s for s in ([1, 1, 1], [-1, 1, 1], [1, -1, 1], [-1, -1, 1])] + [[[0.0, 0.0, 0.0]]]
    )
    coords = torch.tensor(atoms[None], dtype=torch.float64, device=cuda).repeat(4, 1, 1).contiguous()
    vdw = torch.full(coords.shape[:2], 1.5, dtype=torch.float64, device=cuda)
    z = torch.tensor([0.0, 0.5, -0.5, 1.0], dtype=torch.float64, device=cuda)
    half = torch.tensor([1.0, 2.0, 0.5, 1.5], dtype=torch.float64, device=cuda)
    from pywindow_torch.ops import optim
    from pywindow_torch.ops.encoding import unmasked
    from pywindow_torch.ops.geometry import clearance_diff

    anchor = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], -1)
    seen = []

    def f_xy(xys):
        disp = torch.cat([xys, torch.zeros_like(xys[..., :1])], -1)
        vals = -2.0 * clearance_diff(anchor, disp, unmasked(coords, vdw))
        seen.append(vals)
        return vals

    optim.brute_start(f_xy, torch.stack([-half, -half], -1), torch.stack([half, half], -1), ns)
    grid = seen[0]
    ties = (grid == grid.amin(-1, keepdim=True)).sum(-1)
    assert bool((ties > 1).any()), "no exact tie on the grid"
    got = nm_kernels.nm_xy_flat_cuda(coords, vdw, z, half, brute_ns=ns)
    want = nm_kernels.nm_xy_flat_plain(coords, vdw, z, half, brute_ns=ns)
    torch.cuda.synchronize()
    assert _equal(got, want)


@pytest.mark.parametrize("name", ["PUDXES", "REYMAL"])
def test_optimiser_kernels_equal_plain_on_real_window_lanes(cuda, monkeypatch, name):
    """Every lbfgsb_stable and nm_xy call of a molecule's analysis on the
    card (pore, window z with inactive slots, window xy) against the plain
    version on the same inputs, with torch.equal."""
    calls = []
    for module, attr, key in (
        (lbfgsb_kernels, "lbfgsb_stable_flat_cuda", "lbfgsb"),
        (nm_kernels, "nm_xy_flat_cuda", "nm"),
    ):
        fn = getattr(module, attr)

        def record(*args, _fn=fn, _key=key, **kwargs):
            calls.append((_key, args, dict(kwargs)))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, attr, record)
    path = DATA / f"{name}.xyz"
    pt.MolecularSystem.load_file(path).system_to_molecule().full_analysis()
    monkeypatch.undo()
    assert {k for k, _, _ in calls} == {"lbfgsb", "nm"}
    assert any(k.get("active") is not None and not bool(k["active"].all()) for _, _, k in calls)
    for key, args, kwargs in calls:
        if key == "lbfgsb":
            got = lbfgsb_kernels.lbfgsb_stable_flat_cuda(*args, **kwargs)
            want = lbfgsb_kernels.lbfgsb_stable_flat_plain(*args, **kwargs)
        else:
            got = nm_kernels.nm_xy_flat_cuda(*args, **kwargs)
            want = nm_kernels.nm_xy_flat_plain(*args, **kwargs)
        torch.cuda.synchronize()
        assert _equal(got, want), (key, args[0].shape)


# -- the culled ray kernels -------------------------------------------------


def _exit_arithmetic(unit, rel, vdw, origin, want_exit):
    """ray_exit's pair arithmetic over every atom, op by op in torch (one
    rounding per operation, as the kernel's -fmad=false build): the
    outputs of the kernel before its cone cull."""
    u0, u1, u2 = (unit[..., :, None, k] for k in range(3))
    x0, x1, x2 = (rel[..., None, :, k] for k in range(3))
    r = vdw[..., None, :]
    t_ca = u0 * x0 + u1 * x1 + u2 * x2
    q0 = x0 - t_ca * u0
    q1 = x1 - t_ca * u1
    q2 = x2 - t_ca * u2
    under = r * r - (q0 * q0 + q1 * q1 + q2 * q2)
    o0, o1, o2 = (origin[:, None, k] for k in range(3))
    ou = (o0 * unit[..., 0] + o1 * unit[..., 1] + o2 * unit[..., 2])[..., None]
    oo = (o0 * o0 + o1 * o1 + o2 * o2)[..., None]
    front = (under > 0.0) & (t_ca + ou > 0.0)
    hit = front.any(-1)
    if not want_exit:
        return hit, torch.full_like(unit[..., 0], -1e30)
    t1 = t_ca + torch.sqrt(torch.where(front, under, 0.0))
    best = torch.where(front, t1 * (t1 + (ou + ou)) + oo, -1e30).amax(-1)
    return hit, torch.where(hit, torch.sqrt(torch.clamp_min(best, 0.0)), -1e30)


def _shells(b, n, seed, dtype, device, pad=8):
    """(coords, vdw, rel, origin) of b hollow random shells of n atoms and
    ``pad`` padded atoms (coords 1e6, rel 0, vdW 0)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = pts * rng.uniform(5.0, 9.0, (b, 1, 1)) + rng.normal(scale=0.4, size=(b, n, 3))
    coords = np.concatenate([pts, np.full((b, pad, 3), 1.0e6)], 1)
    vdw = np.concatenate([rng.uniform(1.2, 1.9, (b, n)), np.zeros((b, pad))], 1)
    origin = pts.mean(1)
    rel = np.concatenate([pts - origin[:, None], np.zeros((b, pad, 3))], 1)

    def f(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return f(coords), f(vdw), f(rel), f(origin)


def _spiral_units(p, b, dtype, device):
    pts = rays.golden_spiral(p, torch.ones(b, dtype=dtype, device=device))
    return pts / torch.sqrt((pts * pts).sum(-1, keepdim=True))


def _assert_exit_kernel_exact(unit, rel, vdw, origin, order):
    for want in (True, False):
        got = ray_kernels.ray_exit_cuda(unit, rel, vdw, origin, want, order)
        want_out = _exit_arithmetic(unit, rel, vdw, origin, want)
        torch.cuda.synchronize()
        assert _equal(got, want_out), want


def _assert_sweep_kernel_exact(vectors, chunks, coords, vdw, max_steps):
    got = ray_kernels.path_sweep_cuda(vectors, chunks, coords, vdw, max_steps)
    want = ray_kernels.path_sweep_plain(vectors, chunks, coords, vdw, max_steps)
    torch.cuda.synchronize()
    assert _equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ray_exit_kernel_same_outputs_in_any_order(cuda, dtype):
    """The spiral's tile order, index order, reversed and random orders
    give the same outputs bit for bit, equal to the pair arithmetic over
    every atom, and within today's tolerances of the plain version."""
    _, vdw, rel, origin = _shells(3, 140, 11, dtype, cuda)
    unit = _spiral_units(333, 3, dtype, cuda)
    orders = [
        rays.spiral_tile_order(333, cuda),
        torch.arange(333, dtype=torch.int32, device=cuda),
        torch.arange(332, -1, -1, dtype=torch.int32, device=cuda),
        torch.tensor(np.random.default_rng(3).permutation(333), dtype=torch.int32, device=cuda),
    ]
    outs = [ray_kernels.ray_exit_cuda(unit, rel, vdw, origin, True, o) for o in orders]
    for out in outs[1:]:
        assert _equal(out, outs[0])
    for order in orders:
        _assert_exit_kernel_exact(unit, rel, vdw, origin, order)
    hp, ep = ray_kernels.ray_exit_plain(unit, rel, vdw, origin, True)
    hk, ek = outs[0]
    torch.cuda.synchronize()
    if dtype == torch.float64:
        assert torch.equal(hk, hp)
    assert int((hk != hp).sum()) <= 0.005 * hk.numel()
    both = hk & hp
    assert float((ek - ep)[both].abs().max()) <= (1e-9 if dtype == torch.float64 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ray_exit_kernel_exact_on_tangent_rays_and_padded_atoms(cuda, dtype):
    """Atoms tangent to chosen spiral rays to rounding (and one part in
    1e7 inside and outside), an atom around the origin, padded atoms."""
    p = 400
    unit = _spiral_units(p, 1, dtype, cuda)
    rng = np.random.default_rng(2)
    u64 = unit[0].double().cpu().numpy()
    atoms, radii = [], []
    for j, k in enumerate(rng.choice(p, 40, replace=False)):
        w = np.cross(u64[k], rng.normal(size=3))
        w /= np.linalg.norm(w)
        r = rng.uniform(1.2, 1.8)
        atoms.append(rng.uniform(-9.0, 9.0) * u64[k] + r * w)
        radii.append(r * (1.0 + (j % 3 - 1) * 1e-7))
    atoms.append([0.2, 0.1, -0.3])
    radii.append(1.5)
    rel = torch.tensor(np.concatenate([atoms, np.zeros((9, 3))])[None], dtype=dtype, device=cuda)
    vdw = torch.tensor(np.concatenate([radii, np.zeros(9)])[None], dtype=dtype, device=cuda)
    origin = torch.tensor([[0.4, -0.7, 0.2]], dtype=dtype, device=cuda)
    _assert_exit_kernel_exact(unit, rel, vdw, origin, rays.spiral_tile_order(p, cuda))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [472, 1700])
def test_ray_kernels_exact_on_large_molecules(cuda, dtype, n):
    """N = 472 (REYMAL's padded size) and N = 1,700 (in float64
    path_sweep's block needs more than 48 KB of dynamic shared memory for
    its atom records and bounds)."""
    coords, vdw, rel, origin = _shells(2, n - 8, 12, dtype, cuda)
    assert ray_kernels.path_sweep_smem_bytes(n, 8) > 48 * 1024 or n < 1000
    vectors = rays.golden_spiral(384, torch.tensor([11.0, 13.0], dtype=dtype, device=cuda))
    _, chunks = rays._chunks(vectors, 0.8)
    _assert_sweep_kernel_exact(vectors, chunks, coords, vdw, 24)
    _assert_exit_kernel_exact(_spiral_units(947, 2, dtype, cuda), rel, vdw, origin, rays.spiral_tile_order(947, cuda))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", [1, 33])
def test_ray_kernels_exact_with_few_rays(cuda, dtype, p):
    """P = 1 and P = 33: a lone ray, and a last tile of one ray."""
    coords, vdw, rel, origin = _shells(2, 100, 13, dtype, cuda)
    vectors = rays.golden_spiral(p, torch.tensor([10.0, 12.0], dtype=dtype, device=cuda))
    _, chunks = rays._chunks(vectors, 1.0)
    _assert_sweep_kernel_exact(vectors, chunks, coords, vdw, 16)
    _assert_exit_kernel_exact(_spiral_units(p, 2, dtype, cuda), rel, vdw, origin, rays.spiral_tile_order(p, cuda))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ray_kernels_exact_on_1440_frames(cuda, dtype):
    """B = 1,440 synthetic frames (a sweep chunk) in one launch each."""
    coords, vdw, rel, origin = _shells(1440, 60, 14, dtype, cuda)
    radius = torch.linspace(9.0, 12.0, 1440, dtype=dtype, device=cuda)
    vectors = rays.golden_spiral(96, radius)
    _, chunks = rays._chunks(vectors, 1.0)
    _assert_sweep_kernel_exact(vectors, chunks, coords, vdw, 16)
    _assert_exit_kernel_exact(_spiral_units(200, 1440, dtype, cuda), rel, vdw, origin, rays.spiral_tile_order(200, cuda))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_path_sweep_kernel_exact_on_adversarial_rays(cuda, dtype):
    """Zero rays (chunks 1), max_steps below chunks + 1 and above 32 (the
    kernel wraps its steps), a ray blocked by an atom on its segment
    (U < 0), an atom around the origin, padded atoms, a sphere surface on
    a probe to the ulp, and an equidistant cylinder where nothing is
    culled."""
    coords, vdw, _, _ = _shells(2, 60, 15, dtype, cuda, pad=4)
    rng = np.random.default_rng(15)
    vec = rng.normal(size=(2, 40, 3))
    vec = vec / np.linalg.norm(vec, axis=-1, keepdims=True) * rng.uniform(2.0, 12.0, (2, 40, 1))
    vec[:, :8] = 0.0
    vectors = torch.tensor(vec, dtype=dtype, device=cuda)
    _, chunks = rays._chunks(vectors, 0.25)
    chunks[:, :8] = 1
    coords[1, 0] = vectors[1, 10] * 0.5
    coords[1, 1] = torch.tensor([0.3, -0.2, 0.1], dtype=dtype, device=cuda)
    vdw[1, 1] = 1.0
    for max_steps in (5, 16, 49):
        _assert_sweep_kernel_exact(vectors, chunks, coords, vdw, max_steps)
    # a surface through the probe at x = 1.5 of the ray (4, 0, 0), chunks 8
    d = torch.tensor(2.25, dtype=dtype, device=cuda)
    ring = np.arange(8) * np.pi / 4
    cyl = [[0.5 * l, 3.0 * np.cos(a), 3.0 * np.sin(a)] for l in range(9) for a in ring]
    for r in (d, torch.nextafter(d, d - 1), torch.nextafter(d, d + 1)):
        co = torch.tensor([[[1.5, 2.25, 0.0]] + cyl], dtype=dtype, device=cuda)
        vd = torch.full(co.shape[:2], 1.25, dtype=dtype, device=cuda)
        vd[0, 0] = r
        v = torch.tensor([[[4.0, 0.0, 0.0]]], dtype=dtype, device=cuda)
        ch = torch.full((1, 1), 8, dtype=torch.int32, device=cuda)
        _assert_sweep_kernel_exact(v, ch, co, vd, 12)
        _assert_sweep_kernel_exact(v, ch, co[:, 1:].contiguous(), vd[:, 1:].contiguous(), 12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_path_sweep_kernel_same_outputs_at_any_rays_per_warp(cuda, dtype, monkeypatch):
    """1, 2, 4 and 8 rays a warp (grids of 48 down to 6 blocks a frame)
    give the plain version's outputs bit for bit, zero rays included."""
    coords, vdw, _, _ = _shells(3, 160, 16, dtype, cuda)
    vectors = rays.golden_spiral(384, torch.tensor([11.0, 9.5, 12.5], dtype=dtype, device=cuda))
    vectors[:, 265:] = 0.0
    _, chunks = rays._chunks(vectors, 1.0)
    for rpw in (1, 2, 4, 8):
        monkeypatch.setattr(ray_kernels, "sweep_rays_per_warp", lambda f, r, s, k=rpw: k)
        _assert_sweep_kernel_exact(vectors, chunks, coords, vdw, 16)


def test_ray_kernel_launches_per_pipeline_call(cuda):
    """One pipeline call launches ray_exit twice (pre-analysis, average
    diameter) and path_sweep once, for 1 frame as for 5."""
    from pywindow_torch.parallel import batch

    elements, coords = _pudxes()
    for n_frames in (1, 5):
        _cuda.LAUNCHES.clear()
        batch.collect_batch(
            batch.dispatch_batch([(elements, coords)] * n_frames, reference_max_diameter=22.179369990077188)
        )
        assert _cuda.LAUNCHES["ray_exit"] == 2 and _cuda.LAUNCHES["path_sweep"] == 1


def _sweep(fn, elements, coords, maxd, batch_size, **kwargs):
    from pywindow_torch.parallel import batch

    got: dict = {}
    batch.LEARNED_CAPS._caps.clear()
    if fn == "uniform":
        batch.sweep_uniform(
            elements, coords, maxd, lambda pos, res: got.update(zip(pos.tolist(), res)),
            batch_size=batch_size,
        )
        return got

    def decode_slab(lo, hi, out64=None, out32=None):
        for out in (out64, out32):
            if out is not None:
                out[...] = coords[lo:hi]
        return maxd[lo:hi]

    batch.sweep_stream(
        elements, len(coords), decode_slab, lambda pos, res: got.update(zip(pos.tolist(), res)),
        batch_size=batch_size, **kwargs,
    )
    return got


@pytest.mark.parametrize("scaled", [False, True])
def test_sweep_stream_on_the_card_equals_sweep_uniform(cuda, scaled):
    """The streamed sweep's card path (the pinned store, the copy and
    fetch streams, the collector thread) against sweep_uniform on the
    card, bit for bit: 22 fixture frames in chunks of 4 (the last chunk
    of 2 frames at its own size), and 8 frames then the same scaled by
    1.35 in chunks of 8 (a restart at grown sampling sizes)."""
    from pywindow_torch.ops.analysis import max_dim_host

    fr = pt.DLPOLY(DATA / "HISTORY_singlemol_short").get_frames(
        list(range(20)), swap_atoms={"he": "H"}, forcefield="OPLS"
    )
    elements = np.asarray(fr[0].system["elements"])
    coords = np.stack([fr[k % 20].system["coordinates"] for k in range(22)])
    size = 4
    if scaled:
        coords = np.concatenate([coords[:8], coords[:8] * 1.35])
        size = 8
    maxd = np.array([max_dim_host(elements, c) for c in coords])
    gate: dict = {"final": False}
    uniform = _sweep("uniform", elements, coords, maxd, size)
    stream = _sweep("stream", elements, coords, maxd, size, size_gate=gate)
    assert gate["final"] and sorted(stream) == sorted(uniform) == list(range(len(coords)))
    for f in uniform:
        for key, sub in (("pore_diameter_opt", "diameter"), ("average_diameter", None),
                         ("windows", "diameters"), ("windows", "centre_of_mass")):
            a = stream[f][key] if sub is None else stream[f][key][sub]
            b = uniform[f][key] if sub is None else uniform[f][key][sub]
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(a, b)


def _assert_props_identical(got: dict, ref: dict) -> None:
    """Two properties dicts: the same keys, every value bit for bit."""
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        g = got[key]
        pairs = [(g[k], r[k], f"{key}.{k}") for k in r] if isinstance(r, dict) else [(g, r, key)]
        for a, b, name in pairs:
            assert (a is None) == (b is None), name
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=name)


_RANK_WORKER = r"""
import pickle, sys
import torch
import pywindow_torch as pt
from pywindow_torch.parallel import distributed

rank, port, path, out = sys.argv[1:5]
distributed.initialize(f"127.0.0.1:{port}", 2, int(rank), backend="gloo")
traj = pt.DLPOLY(path)
distributed.analysis_batched_distributed(
    traj, swap_atoms={"he": "H"}, forcefield="OPLS", device="cuda:0", batch_size=8
)
assert "jax" not in sys.modules
with open(out, "wb") as fh:
    pickle.dump(traj.analysis_output, fh)
torch.distributed.destroy_process_group()
"""


def test_two_gloo_ranks_on_one_card_equal_the_single_process_sweep(cuda, tmp_path):
    """Two gloo ranks on the first card sweep the 20 fixture frames (10
    each); both hold all 20, equal to this process's analysis_batched on
    cuda:0 bit for bit.  A rank that fails or runs past 300 s fails."""
    import os
    import pickle
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    history = DATA / "HISTORY_singlemol_short"
    root = pathlib.Path(__file__).resolve().parent.parent
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    procs, outs = [], []
    for r in range(2):
        outs.append(tmp_path / f"rank_{r}.pkl")
        env = {**os.environ, "PYTHONPATH": str(root), "CUDA_VISIBLE_DEVICES": first,
               "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_WORKER, str(r), str(port), str(history), str(outs[r])],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    single = pt.DLPOLY(history)
    single.analysis_batched(swap_atoms={"he": "H"}, forcefield="OPLS", batch_size=8, device="cuda:0")
    for out in outs:
        with out.open("rb") as fh:
            got = pickle.load(fh)
        assert sorted(got) == sorted(single.analysis_output) == list(range(20))
        for f in got:
            _assert_props_identical(got[f]["0"], single.analysis_output[f]["0"])
