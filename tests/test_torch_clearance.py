"""``clearance_min``: the port's plain version against the JAX package's
Pallas kernel (``clearance_min_pallas``, run as its own tests run it on
the CPU, in interpret mode) on the shapes and seeds of
tests/test_pallas.py, at 1e-10 Å in float64.  The CUDA kernel is held
against the plain version on the card (tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

from pywindow_torch.ops import clearance_kernels
from pywindow_tpu.ops.pallas_kernels import clearance_min_pallas

TOL = 1e-10


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize(("q", "n"), [(100, 50), (1024, 256), (513, 129)])
def test_plain_matches_pallas(q, n):
    rng = np.random.default_rng(q + n)
    probes = rng.normal(size=(q, 3)) * 10
    coords = rng.normal(size=(n, 3)) * 12
    vdw = rng.uniform(1.0, 2.0, n)
    ref = np.asarray(clearance_min_pallas(probes, coords, vdw, interpret=True))
    got = clearance_kernels.clearance_min_plain(_t(probes), _t(coords), _t(vdw))
    assert got.shape == (q,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    # the entry point takes the plain version for CPU tensors
    same = clearance_kernels.clearance_min(_t(probes), _t(coords), _t(vdw))
    assert torch.equal(same, got)


def test_padded_atoms_never_win():
    """Atoms parked at 1e6 with vdW 0 (the MolArrays padding) change
    nothing, in the port and in the JAX kernel."""
    rng = np.random.default_rng(3)
    coords = np.concatenate([rng.normal(size=(40, 3)) * 5, np.full((24, 3), 1.0e6)])
    vdw = np.concatenate([rng.uniform(1, 2, 40), np.zeros(24)])
    probes = rng.normal(size=(64, 3)) * 5
    ref = np.asarray(clearance_min_pallas(probes, coords, vdw, interpret=True))
    padded = clearance_kernels.clearance_min(_t(probes), _t(coords), _t(vdw))
    bare = clearance_kernels.clearance_min(_t(probes), _t(coords[:40]), _t(vdw[:40]))
    assert torch.equal(padded, bare)
    np.testing.assert_allclose(padded.numpy(), ref, atol=TOL, rtol=0)


def test_float32_follows_the_probes():
    rng = np.random.default_rng(11)
    probes = torch.tensor(rng.normal(size=(32, 3)) * 4, dtype=torch.float32)
    coords = torch.tensor(rng.normal(size=(20, 3)) * 6, dtype=torch.float32)
    vdw = torch.tensor(rng.uniform(1, 2, 20), dtype=torch.float32)
    got = clearance_kernels.clearance_min(probes, coords, vdw)
    assert got.dtype == torch.float32
    ref = clearance_kernels.clearance_min(probes.double(), coords.double(), vdw.double())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
