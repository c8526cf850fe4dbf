"""The ``dbscan`` kernel's algorithm on the CPU, through its mirror
:func:`~pywindow_torch.ops.cluster_kernels.dbscan_mirror` (order-preserving
compaction of the valid points, each unordered pair tested once,
union-find hooking the larger root under the smaller, root ranks by a
prefix count): label for label equal to the plain version
(``cluster.dbscan``, the min-label propagation) and to the JAX package's
``cluster.dbscan``, on PUDXES's and REYMAL's main-path calls
(``full_analysis(device="cpu")``, float64 and the card's float32
configuration), random clustered sets, a long chain, pairs at exactly
``sqrt(d^2) == eps`` where ``d^2 != eps^2`` in float32, all-invalid frames
and more components than ``max_clusters``; that the tile pairs the kernel
does not test (:func:`~pywindow_torch.ops.cluster_kernels.dbscan_far_tiles`)
hold no pair within eps; and the kernel's launch rule and size routes.  The kernel itself is held against the plain version
on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pywindow_torch as pt
from pywindow_torch.ops import _cuda, cluster, windows
from pywindow_torch.ops import cluster_kernels as ck
from pywindow_torch.ops.geometry import sq_norm3
from pywindow_tpu.ops.cluster import dbscan as jdbscan
from tests.conftest import DATA

DTYPES = [torch.float64, torch.float32]


def _assert_labels_agree(points, valid, eps, min_samples, max_clusters, jax_too=True):
    """Mirror == plain == JAX package, frame by frame; returns the labels."""
    mirror = ck.dbscan_mirror(points, valid, eps, min_samples, max_clusters)
    plain, n_plain = cluster.dbscan(points, valid, eps, min_samples, max_clusters)
    assert mirror.dtype == torch.int32
    assert torch.equal(mirror, plain)
    assert torch.equal(mirror.amax(-1) + 1, n_plain)  # the wrapper's n_clusters rule
    if jax_too:
        for f in range(points.shape[0]):
            l_j, n_j = jdbscan(
                jnp.asarray(points[f].numpy()), jnp.asarray(valid[f].numpy()),
                jnp.asarray(eps[f].numpy()), min_samples, max_clusters,
            )
            np.testing.assert_array_equal(mirror[f].numpy(), np.asarray(l_j))
            assert int(n_plain[f]) == int(n_j)
    return mirror


@functools.cache
def _main_path_calls(name: str, f32: bool):
    """Every dbscan call (points, valid, eps, min_samples, max_clusters) of
    ``full_analysis(device="cpu")``: float64, or the card's float32
    configuration."""
    calls = []
    fn = windows.dbscan

    def rec(points, valid, eps, min_samples, max_clusters):
        calls.append((points, valid, eps, min_samples, max_clusters))
        return fn(points, valid, eps, min_samples=min_samples, max_clusters=max_clusters)

    old = os.environ.get("PYWINDOW_TORCH_FORCE_F32")
    windows.dbscan = lambda p, v, e, min_samples, max_clusters: rec(p, v, e, min_samples, max_clusters)
    try:
        if f32:
            os.environ["PYWINDOW_TORCH_FORCE_F32"] = "1"
        mol = pt.MolecularSystem.load_file(DATA / f"{name}.xyz").system_to_molecule()
        mol.full_analysis(device="cpu")
    finally:
        windows.dbscan = fn
        if old is None:
            os.environ.pop("PYWINDOW_TORCH_FORCE_F32", None)
        else:
            os.environ["PYWINDOW_TORCH_FORCE_F32"] = old
    return calls


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("name", ["PUDXES", "REYMAL"])
def test_mirror_equals_plain_and_jax_on_main_path_calls(name, f32):
    calls = _main_path_calls(name, f32)
    assert calls
    for points, valid, eps, min_samples, max_clusters in calls:
        assert points.dtype == (torch.float32 if f32 else torch.float64)
        labels = _assert_labels_agree(points, valid, eps, min_samples, max_clusters)
        # a cage's windows: several clusters of the open rays' endpoints
        assert int(labels.max()) >= 1


def _clumpy(rng, b, k, nblob, spread=0.4):
    pts = np.empty((b, k, 3))
    for f in range(b):
        parts = []
        for _ in range(nblob):
            c = rng.normal(size=3)
            c *= 5.0 / np.linalg.norm(c)
            parts.append(c + rng.normal(scale=spread, size=(k // nblob, 3)))
        parts.append(rng.normal(scale=6.0, size=(k - (k // nblob) * nblob, 3)))
        pts[f] = np.concatenate(parts)
    return pts


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(4))
def test_mirror_on_random_clustered_sets(seed, dtype):
    rng = np.random.default_rng(40 + seed)
    b, k = 3, int(rng.integers(30, 260))
    pts = _clumpy(rng, b, k, int(rng.integers(1, 7)))
    valid = rng.random((b, k)) > 0.15
    eps = rng.uniform(0.5, 2.0, b)
    _assert_labels_agree(
        torch.tensor(pts, dtype=dtype), torch.tensor(valid), torch.tensor(eps, dtype=dtype),
        int(rng.integers(2, 7)), 4 if seed == 0 else 8,
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_mirror_on_a_long_chain(dtype):
    """A 200-point chain (graph diameter 199: the plain version needs ~200
    propagation passes) shuffled among noise, with a second short chain
    whose root index is smaller than part of the first."""
    rng = np.random.default_rng(7)
    chain = np.stack([np.arange(200) * 0.45, np.zeros(200), np.zeros(200)], -1)
    chain[:, 1] = 0.05 * np.sin(np.arange(200))
    short = np.stack([np.arange(12) * 0.45, np.full(12, 30.0), np.zeros(12)], -1)
    noise = rng.uniform(-40.0, 40.0, (40, 3)) + np.array([0.0, 0.0, 60.0])
    pts = np.concatenate([chain, short, noise])
    perm = rng.permutation(len(pts))
    pts = pts[perm][None]
    valid = np.ones((1, len(perm)), dtype=bool)
    valid[0, perm >= 212] = rng.random(40) > 0.5  # some noise invalid
    labels = _assert_labels_agree(
        torch.tensor(pts, dtype=dtype), torch.tensor(valid), torch.tensor([0.5], dtype=dtype), 3, 8
    )
    inv = np.argsort(perm)
    on_chain = labels[0, inv[:200]]
    assert bool((on_chain == on_chain[0]).all()) and int(on_chain[0]) >= 0
    assert int(labels[0, inv[200]]) >= 0 and int(labels[0, inv[200]]) != int(on_chain[0])


def _eps_ties(n):
    """n float32 vectors v with sqrt(|v|^2) == s exactly in float32 (torch
    and IEEE agree on the root) while fl(s * s) < |v|^2: at eps = s the
    point pair (0, v) is within eps, and a d^2 <= eps^2 test would say
    no."""
    rng = np.random.default_rng(11)
    v = rng.uniform(-1.0, 1.0, (4 * n, 3)).astype(np.float32)
    d2 = (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
    s = np.sqrt(d2)
    torch_s = torch.sqrt(torch.from_numpy(d2)).numpy()
    tie = (torch_s == s) & (d2 > s * s) & (s > 0.5)
    return v[tie][:n], s[tie][:n]


@pytest.mark.parametrize("min_samples", [2, 3])
def test_mirror_on_exact_eps_ties_in_float32(min_samples):
    """Frames of a tie pair (0, v) at eps = sqrt(|v|^2), v doubled (core
    at min_samples 3), 2v (a tie from v again: 2v - v is exactly v, and
    2|v| from the origin) and far noise: the four points are one cluster
    only under sqrt(d^2) <= eps."""
    v, s = _eps_ties(8)
    assert len(v) == 8
    b = len(v)
    rng = np.random.default_rng(12)
    pts = np.zeros((b, 12, 3), dtype=np.float32)
    pts[:, 1] = v
    pts[:, 2] = v  # a duplicate: the pair is core at min_samples 3
    pts[:, 3] = 2 * v
    pts[:, 4:] = rng.uniform(20.0, 40.0, (b, 8, 3)).astype(np.float32)
    points = torch.tensor(pts)
    d2 = (points[:, 1] * points[:, 1]).sum(-1)
    eps = torch.tensor(s)
    assert not bool((d2 <= eps * eps).any())  # the squared test would miss every pair
    labels = _assert_labels_agree(points, torch.ones((b, 12), dtype=torch.bool), eps, min_samples, 8)
    assert bool((labels[:, :4] == 0).all())


def test_mirror_on_invalid_frames_and_folded_clusters():
    """An all-invalid frame, an empty-valid frame with one point, and ten
    well-separated blobs under max_clusters 4 (ranks 4-9 fold to -1)."""
    rng = np.random.default_rng(13)
    centres = np.stack([np.arange(10) * 20.0, np.zeros(10), np.zeros(10)], -1)
    blobs = (centres[:, None, :] + rng.normal(scale=0.3, size=(10, 12, 3))).reshape(120, 3)
    pts = np.stack([blobs, rng.normal(size=(120, 3)), blobs[::-1]])
    valid = np.ones((3, 120), dtype=bool)
    valid[1] = False
    valid[1, 7] = True
    labels = _assert_labels_agree(
        torch.tensor(pts), torch.tensor(valid), torch.tensor([1.0, 1.0, 1.0]), 5, 4
    )
    assert bool((labels[1] == -1).all())
    assert int(labels[0].max()) == 3 and int((labels[0] == -1).sum()) == 72
    assert int((labels[2] >= 0).sum()) == 48


@pytest.mark.parametrize(("frames", "want"), [(1, 1024), (132, 1024), (133, 512), (264, 512), (265, 256), (1440, 256)])
def test_dbscan_threads_fill_one_wave(frames, want):
    """One block a frame, the widest whose blocks hold the launch in one
    wave on 132 SMs (one of 1,024 threads or two of 512 an SM), else 256."""
    assert ck.dbscan_threads(frames, 132) == want


def test_dbscan_size_routes():
    """The eps-graph is stored up to K = 1,253 (float32) and 1,194
    (float64); beyond, the unstored route's block fits up to K = 9,153 and
    5,481; larger K keeps the frame in a global scratch of the unstored
    layout, so no K is refused."""
    for size, last in ((4, 1253), (8, 1194)):
        assert ck.dbscan_route(last, size) == "stored" and ck.dbscan_route(last + 1, size) == "shared"
    assert ck.dbscan_smem_bytes(384, 4, True) == 28304
    for size, last in ((4, 9153), (8, 5481)):
        assert ck.dbscan_route(last, size) == "shared"
        assert ck.dbscan_route(last + 1, size) == "global"
        assert ck.dbscan_smem_bytes(last + 1, size, False) > _cuda.SMEM_LIMIT
        with pytest.raises(ValueError, match="shared memory"):
            _cuda.check_smem("dbscan", ck.dbscan_smem_bytes(last + 1, size, False))
        frame = ck.dbscan_frame_bytes(last + 1, size)
        assert frame % 256 == 0 and 0 <= frame - ck.dbscan_smem_bytes(last + 1, size, False) < 256
    assert ck.dbscan_route(100_000, 4) == "global"


def _far_tiles_hold_nothing(points, valid, eps):
    """No tile pair that ``dbscan_far_tiles`` skips holds a pair within eps
    (``sqrt(d^2) <= eps``, the plain version's test); returns the share
    of the tile pairs skipped."""
    skipped, total = 0, 0
    for f in range(points.shape[0]):
        pts = points[f, valid[f]]
        n = pts.shape[0]
        if n == 0:
            continue
        far = ck.dbscan_far_tiles(pts, eps[f])
        tile = torch.arange(n) // 32
        within = torch.sqrt(sq_norm3(pts[:, None, :] - pts[None, :, :])) <= eps[f]
        assert not bool((within & far[tile[:, None], tile[None, :]]).any())
        assert torch.equal(far, far.T) and not bool(far.diagonal().any())
        skipped += int(far.sum())
        total += far.numel()
    return skipped / max(total, 1)


@pytest.mark.parametrize("case", ["PUDXES-f64", "PUDXES-f32", "REYMAL-f64", "REYMAL-f32"])
def test_far_tiles_on_main_path_calls(case):
    """The boxes of the spiral-ordered endpoints' 32-point tiles (z-bands)
    rule out a share of the tile pairs of a cage, none holding a pair
    within eps."""
    name, dt = case.split("-")
    shares = [
        _far_tiles_hold_nothing(points, valid, eps)
        for points, valid, eps, _, _ in _main_path_calls(name, dt == "f32")
    ]
    assert max(shares) > 0.2


@pytest.mark.parametrize("dtype", DTYPES)
def test_far_tiles_never_skip_a_pair_at_eps(dtype):
    """Two tiles, the second the first moved by a vector of length within
    a few ulps of eps (so the nearest pair sits on the boundary, some
    exactly at sqrt(d^2) == eps) in 64 directions, and tiles far apart."""
    rng = np.random.default_rng(14)
    frames = []
    eps_all = []
    for f in range(64):
        base = rng.normal(scale=0.5, size=(32, 3))
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        # the pair of extreme points along u, moved to touch at eps
        e = float(rng.uniform(0.5, 3.0))
        lo_pt = base[np.argmax(base @ u)]
        hi_pt = base[np.argmin(base @ u)]
        shift = lo_pt - hi_pt + u * e * (1.0 + (f % 5 - 2) * 1e-7)
        frames.append(np.concatenate([base, base + shift, base + 10.0 * e * u]))
        eps_all.append(e)
    points = torch.tensor(np.stack(frames), dtype=dtype)
    eps = torch.tensor(eps_all, dtype=dtype)
    valid = torch.ones(points.shape[:2], dtype=torch.bool)
    assert _far_tiles_hold_nothing(points, valid, eps) > 0.0
    _assert_labels_agree(points, valid, eps, 3, 8, jax_too=False)
