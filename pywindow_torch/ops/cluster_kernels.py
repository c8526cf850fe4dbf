"""The ``dbscan`` kernel (counterpart of ``pywindow_tpu.ops.cluster_pallas``).

:func:`dbscan` takes the plain version (:func:`pywindow_torch.ops.cluster.dbscan`)
for CPU tensors and the CUDA kernel (``csrc/dbscan.cu``) for CUDA
tensors, with no size gate and no fallback.  The kernel returns labels
only; ``n_clusters = max(labels) + 1`` equals the plain version's
``min(#components, max_clusters)`` because every component root carries
its own rank.
"""

from __future__ import annotations

import torch

from pywindow_torch.ops import _cuda
from pywindow_torch.ops import cluster as _cluster


def dbscan_labels_cuda(
    points: torch.Tensor,
    valid: torch.Tensor,
    eps: torch.Tensor,
    min_samples: int,
    max_clusters: int,
) -> torch.Tensor:
    """DBSCAN labels of a flat batch on the card: points (B, K, 3),
    valid (B, K) bool, eps (B,) -> (B, K) int32."""
    dtype = points.dtype
    device = _cuda.check_inputs(
        "dbscan", dtype, points=points, valid=valid, eps=eps
    )
    b, k = points.shape[0], points.shape[1]
    if points.shape != (b, k, 3) or valid.shape != (b, k) or eps.shape != (b,):
        msg = f"dbscan: bad shapes {points.shape}, {valid.shape}, {eps.shape}"
        raise ValueError(msg)
    if valid.dtype != torch.bool:
        msg = f"dbscan: valid must be bool, got {valid.dtype}"
        raise TypeError(msg)
    words = (k + 31) // 32
    adj = torch.empty((b, k, words), dtype=torch.int32, device=device)
    scratch = torch.empty((b, 3, k), dtype=torch.int32, device=device)
    labels = torch.empty((b, k), dtype=torch.int32, device=device)
    _cuda.load_extension().dbscan(
        points, valid, eps, adj, scratch, labels,
        int(min_samples), int(max_clusters),
    )
    _cuda.LAUNCHES["dbscan"] += 1
    return labels


def dbscan(
    points: torch.Tensor,
    valid: torch.Tensor,
    eps: torch.Tensor,
    min_samples: int = 5,
    max_clusters: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels (B, K), n_clusters (B,)) of B point sets (B, K, 3) with
    validity (B, K) and eps (B,); see :func:`pywindow_torch.ops.cluster.dbscan`."""
    if _cuda.device_type("dbscan", points) == "cuda":
        labels = dbscan_labels_cuda(points, valid, eps, min_samples, max_clusters)
        return labels, labels.amax(-1) + 1
    return _cluster.dbscan(points, valid, eps, min_samples, max_clusters)
