"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc``; without a card they skip.
They import neither JAX nor the test conftest's helpers, so on a machine
without JAX they run as
``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

import pywindow_torch as pt
from pywindow_torch.ops import _cuda, cluster, cluster_kernels, ray_kernels, rays
from pywindow_torch.ops.encoding import MolArrays


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mol(n, seed, dtype, device, pad=8):
    rng = np.random.default_rng(seed)
    n_pad = ((n + pad - 1) // pad) * pad
    coords = np.full((n_pad, 3), 1.0e6)
    coords[:n] = rng.normal(size=(n, 3)) * 6
    vdw = np.zeros(n_pad)
    vdw[:n] = rng.uniform(1.2, 2.0, n)
    mask = np.arange(n_pad) < n
    f = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return MolArrays(f(coords), f(vdw), f(vdw), f(vdw), torch.tensor(mask, device=device))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("want_exit", [True, False])
def test_ray_exit_kernel_matches_plain(cuda, dtype, want_exit):
    mol = _mol(150, 1, dtype, cuda)
    pts = rays.golden_spiral(700, torch.tensor(14.0, dtype=dtype, device=cuda))
    unit, rel, origin = rays._ray_frame(pts, mol)
    before = _cuda.LAUNCHES["ray_exit"]
    hk, ek = ray_kernels.ray_exit(unit, rel, mol.vdw, origin, want_exit)
    assert _cuda.LAUNCHES["ray_exit"] == before + 1
    hp, ep = ray_kernels.ray_exit_plain(unit, rel, mol.vdw, origin, want_exit)
    torch.cuda.synchronize()
    agree = hk == hp
    if dtype == torch.float64:
        assert bool(agree.all())
    else:
        assert int((~agree).sum()) <= 0.005 * len(hk)
    both = hk & hp
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    if want_exit:
        assert float((ek - ep)[both].abs().max()) <= tol
    else:
        assert bool((ek == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_path_sweep_kernel_matches_plain(cuda, dtype):
    mol = _mol(168, 2, dtype, cuda)
    vectors = rays.golden_spiral(384, torch.tensor(11.0, dtype=dtype, device=cuda))
    _, chunks = rays._chunks(vectors, 1.0)
    before = _cuda.LAUNCHES["path_sweep"]
    ok_k, pos_k, c_k = ray_kernels.path_sweep(vectors, chunks, mol.coords, mol.vdw, 16)
    assert _cuda.LAUNCHES["path_sweep"] == before + 1
    ok_p, pos_p, c_p = ray_kernels.path_sweep_plain(vectors, chunks, mol.coords, mol.vdw, 16)
    assert torch.equal(ok_k, ok_p) and torch.equal(pos_k, pos_p)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    assert float((c_k - c_p).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k", [384, 1000])
def test_dbscan_kernel_matches_plain(cuda, dtype, k):
    rng = np.random.default_rng(k)
    centres = rng.normal(size=(5, 3))
    pts = np.concatenate(
        [c * 5 + rng.normal(scale=0.4, size=(k // 5, 3)) for c in centres]
        + [rng.normal(scale=6, size=(k - 5 * (k // 5), 3))]
    )
    points = torch.tensor(pts, dtype=dtype, device=cuda)
    valid = torch.tensor(rng.random(k) > 0.1, device=cuda)
    eps = torch.tensor(0.9, dtype=dtype, device=cuda)
    labels_k, n_k = cluster_kernels.dbscan(points, valid, eps, 5, 4)
    labels_p, n_p = cluster.dbscan(points, valid, eps, 5, 4)
    assert torch.equal(labels_k, labels_p)
    assert int(n_k) == int(n_p)


def test_wrappers_raise_on_bad_inputs(cuda):
    x = torch.zeros((10, 3), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        ray_kernels.ray_exit_cuda(x, x.double(), x[:, 0], x[0])
    with pytest.raises(ValueError, match="contiguous"):
        ray_kernels.ray_exit_cuda(x.T.contiguous().T, x, x[:, 0].contiguous(), x[0])


def test_full_analysis_on_the_card_matches_cpu_float32(cuda, monkeypatch):
    """The slice end to end on the card against the same configuration
    (float32 pipeline, float64 stable optimisers) on the CPU, and every
    kernel launched on the way."""
    path = pathlib.Path(__file__).parent / "data" / "PUDXES.xyz"
    mol = pt.MolecularSystem.load_file(path).system_to_molecule()
    _cuda.LAUNCHES.clear()
    gpu = mol.full_analysis(device=cuda)
    assert all(_cuda.LAUNCHES[k] > 0 for k in ("ray_exit", "path_sweep", "dbscan"))
    monkeypatch.setenv("PYWINDOW_TORCH_FORCE_F32", "1")
    cpu = pt.MolecularSystem.load_file(path).system_to_molecule().full_analysis()
    for key in ("pore_diameter", "pore_diameter_opt", "maximum_diameter"):
        assert abs(gpu[key]["diameter"] - cpu[key]["diameter"]) < 1e-3
    np.testing.assert_allclose(
        np.sort(gpu["windows"]["diameters"]), np.sort(cpu["windows"]["diameters"]), atol=1e-3
    )
