"""Dense DBSCAN over sampling-ray endpoints: the plain version of the
``dbscan`` kernel (counterpart of ``pywindow_tpu.ops.cluster.dbscan``,
cluster.py:97-174).

Semantics matched to sklearn (reference: utilities.py:1478-1487):

* neighbourhood = ``dist <= eps`` including the point itself,
* core iff neighbourhood size >= min_samples,
* clusters = connected components of the core-core graph,
* border points join the cluster whose minimal core index is smallest
  among their core neighbours,
* noise label -1; cluster ids renumbered 0, 1, ... by ascending first
  core index; ids at or beyond ``max_clusters`` fold to -1.
"""

from __future__ import annotations

import torch

from pywindow_torch.ops.geometry import sq_norm3

_INT_INF = torch.iinfo(torch.int32).max


def dbscan(
    points: torch.Tensor,
    valid: torch.Tensor,
    eps: torch.Tensor,
    min_samples: int = 5,
    max_clusters: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster ``points`` (..., P, 3) restricted to ``valid`` (..., P).

    Returns ``(labels (..., P) int32, n_clusters (...) int32)``.
    """
    p = points.shape[-2]
    dist = torch.sqrt(sq_norm3(points[..., :, None, :] - points[..., None, :, :]))
    pair_valid = valid[..., :, None] & valid[..., None, :]
    adj = pair_valid & (dist <= torch.as_tensor(eps)[..., None, None])
    core = valid & (adj.sum(-1) >= min_samples)

    idx = torch.arange(p, dtype=torch.int32, device=points.device)
    inf = torch.full_like(idx, _INT_INF)
    labels = torch.where(core, idx, inf)
    core_adj = adj & core[..., :, None] & core[..., None, :]
    while True:  # min-label propagation to the fixpoint
        neigh = torch.where(core_adj, labels[..., None, :], _INT_INF)
        new = torch.minimum(labels, neigh.amin(-1))
        if torch.equal(new, labels):
            break
        labels = new

    border = torch.where(
        adj & core[..., None, :], labels[..., None, :], _INT_INF
    ).amin(-1)
    raw = torch.where(core, labels, torch.where(valid, border, inf))
    is_root = core & (labels == idx)
    # rank(raw) = #roots <= raw, as an exact masked count
    cnt = (is_root[..., None, :] & (idx[None, :] <= raw[..., :, None])).sum(-1)
    rank = (cnt - 1).to(torch.int32)
    out = torch.where((raw == _INT_INF) | (rank >= max_clusters), -1, rank)
    n_clusters = torch.clamp_max(is_root.sum(-1), max_clusters)
    return out.to(torch.int32), n_clusters.to(torch.int32)
