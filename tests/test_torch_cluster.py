"""DBSCAN: the port's plain version (the dbscan kernel's CPU path)
against pywindow_tpu's dense ``cluster.dbscan`` and its Pallas kernel
``dbscan_labels_flat`` in interpret mode, label for label."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywindow_torch.ops import cluster as tcluster
from pywindow_torch.ops import cluster_kernels
from pywindow_tpu.ops.cluster import dbscan as jdbscan
from pywindow_tpu.ops.cluster_pallas import dbscan_labels_flat
from tests.test_torch_parity import t


def _clumpy(rng, k, nblob):
    """Blobby point sets (windows-like: a few dense caps + noise)."""
    pts = []
    for _ in range(nblob):
        c = rng.normal(size=3)
        c /= np.linalg.norm(c)
        pts.append(c * 5.0 + rng.normal(scale=0.4, size=(k // nblob, 3)))
    pts.append(rng.normal(scale=6.0, size=(k - (k // nblob) * nblob, 3)))
    return np.concatenate(pts)[:k]


@pytest.mark.parametrize("seed", range(5))
def test_labels_match_dense_and_pallas(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(20, 300))
    pts = _clumpy(rng, k, int(rng.integers(1, 7)))
    valid = rng.random(k) > 0.15
    eps = float(rng.uniform(0.5, 2.0))
    max_clusters = 4 if seed == 0 else 8  # seed 0 folds clusters to -1

    labels, n_cl = cluster_kernels.dbscan(t(pts), t(valid), t(eps), 5, max_clusters)
    l_j, n_j = jdbscan(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(eps), 5, max_clusters
    )
    np.testing.assert_array_equal(labels.numpy(), np.asarray(l_j))
    assert int(n_cl) == int(n_j)

    l_p = dbscan_labels_flat(
        jnp.asarray(pts)[None], jnp.asarray(valid, jnp.float64)[None],
        jnp.asarray([eps]), 5, max_clusters, interpret=True,
    )[0]
    np.testing.assert_array_equal(labels.numpy(), np.asarray(l_p))
    # the kernel's n_clusters rule: max(labels) + 1
    assert int(labels.max()) + 1 == int(n_cl)


def test_batched_plain_version_and_edge_cases():
    """Leading batch dims run lane-independently (vmap semantics); an
    empty point set and all-noise sets give no clusters."""
    rng = np.random.default_rng(9)
    pts = rng.normal(scale=3.0, size=(3, 130, 3))
    valid = rng.random((3, 130)) > 0.2
    valid[2] = False
    eps = np.array([1.1, 0.9, 1.0])
    labels, n_cl = tcluster.dbscan(t(pts), t(valid), t(eps), 5, 8)
    for b in range(3):
        l_j, n_j = jdbscan(
            jnp.asarray(pts[b]), jnp.asarray(valid[b]), jnp.asarray(eps[b]), 5, 8
        )
        np.testing.assert_array_equal(labels[b].numpy(), np.asarray(l_j))
        assert int(n_cl[b]) == int(n_j)
    assert bool((labels[2] == -1).all()) and int(n_cl[2]) == 0
    l_far, n_far = cluster_kernels.dbscan(
        t(pts[0] * 100.0), t(valid[0]), t(0.5), 5, 8
    )
    assert bool((l_far == -1).all()) and int(n_far) == 0
    assert l_far.dtype == torch.int32


def test_cuda_wrapper_refuses_cpu_tensors():
    pts = torch.zeros((1, 8, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        cluster_kernels.dbscan_labels_cuda(
            pts, torch.ones((1, 8), dtype=torch.bool), torch.ones(1, dtype=torch.float64), 5, 8
        )
