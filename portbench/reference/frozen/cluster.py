"""DBSCAN over sampling-ray endpoints (counterpart of
``pywindow_tpu.ops.cluster``).

:func:`dbscan` is the dense form, the plain version of the ``dbscan``
kernel (cluster.py:97-174).  :func:`dbscan_spiral` clusters points of
the golden spiral through static candidate lists instead of a (P, P)
matrix (cluster.py:38-232); no pipeline calls it, in either package.

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

import functools

import numpy as np
import torch

from portbench.reference.frozen.geometry import sq_norm3

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
    return _finalise(labels, border, core, valid, idx, max_clusters)


def _finalise(labels, border, core, valid, idx, max_clusters):
    """Attach the border points and number the components by ascending
    root index; (labels, n_clusters) as int32."""
    inf = torch.full_like(labels, _INT_INF)
    raw = torch.where(core, labels, torch.where(valid, border, inf))
    is_root = core & (labels == idx)
    # rank(raw) = #roots <= raw, as an exact masked count
    cnt = (is_root[..., None, :] & (idx[None, :] <= raw[..., :, None])).sum(-1)
    rank = (cnt - 1).to(torch.int32)
    out = torch.where((raw == _INT_INF) | (rank >= max_clusters), -1, rank)
    n_clusters = torch.clamp_max(is_root.sum(-1), max_clusters)
    return out.to(torch.int32), n_clusters.to(torch.int32)


#: smallest sampling-sphere radius (Å) the candidate lists stay complete
#: for (any molecule of two or more atoms has a radius above ~1.2 Å)
_R_MIN = 0.5


@functools.lru_cache(maxsize=64)
def spiral_neighbor_candidates(n_points: int) -> np.ndarray:
    """Static (P, K) eps-neighbour candidates of the golden spiral of
    ``n_points`` (counterpart of the JAX package's, cluster.py:38-79).

    The spiral's layout is fixed by the point count; only its radius r
    scales.  The DBSCAN threshold ``eps = m r + sqrt(m r)`` (m: the unit
    sphere's mean 10-NN distance) is ``m + sqrt(m / r)`` in unit-sphere
    distance, decreasing in r, so the lists taken at :data:`_R_MIN`
    (with a 5% margin) hold every eps-pair of any larger sphere.  Slot 0
    is the point itself; missing slots are -1.
    """
    golden_angle = np.pi * (3.0 - np.sqrt(5.0))
    k = np.arange(n_points, dtype=np.float64)
    theta = golden_angle * k
    z = np.linspace(1.0 - 1.0 / n_points, 1.0 / n_points - 1.0, n_points)
    rho = np.sqrt(1.0 - z * z)
    pts = np.stack([rho * np.cos(theta), rho * np.sin(theta), z], axis=-1)
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    m_unit = float(np.sort(d, axis=1)[:, :10].mean())
    within = d <= (m_unit + np.sqrt(m_unit / _R_MIN)) * 1.05
    nbr = np.full((n_points, int(within.sum(axis=1).max())), -1, dtype=np.int32)
    for i in range(n_points):
        js = np.flatnonzero(within[i])
        js = js[np.argsort(d[i, js], kind="stable")]
        nbr[i, : len(js)] = js
    return nbr


def _pointer_halve(labels: torch.Tensor, p: int) -> torch.Tensor:
    """One path-halving step, ``labels = min(labels, labels[labels])``:
    chains of candidate roots shorten, so the propagation takes
    O(log diameter) rounds; the fixpoint is the same."""
    jumped = labels.gather(-1, labels.clamp(0, p - 1).to(torch.int64))
    return torch.minimum(labels, torch.where(labels < p, jumped, _INT_INF))


def dbscan_spiral(
    points: torch.Tensor,
    valid: torch.Tensor,
    eps: torch.Tensor,
    nbr_idx,
    min_samples: int = 5,
    max_clusters: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dbscan` of golden-spiral points (..., P, 3) through the
    candidate lists ``nbr_idx`` of :func:`spiral_neighbor_candidates`
    (P): the same edges (the distance computed as in the dense form),
    components, borders and numbering, on (P, K) pairs instead of
    (P, P) (counterpart of ``pywindow_tpu.ops.cluster.dbscan_spiral``)."""
    p = points.shape[-2]
    nbr = torch.as_tensor(np.asarray(nbr_idx), dtype=torch.int64, device=points.device)
    nbr_ok = nbr >= 0
    safe = nbr.clamp(0, p - 1)
    dist = torch.sqrt(sq_norm3(points[..., :, None, :] - points[..., safe, :]))
    edge = (
        nbr_ok
        & valid[..., :, None]
        & valid[..., safe]
        & (dist <= torch.as_tensor(eps)[..., None, None])
    )  # slot 0 is the point itself
    core = valid & (edge.sum(-1) >= min_samples)

    idx = torch.arange(p, dtype=torch.int32, device=points.device)
    labels = torch.where(core, idx, torch.full_like(idx, _INT_INF))
    core_edge = edge & core[..., :, None] & core[..., safe]
    while True:  # min-label propagation with pointer halving
        neigh = torch.where(core_edge, labels[..., safe], _INT_INF).amin(-1)
        new = _pointer_halve(torch.minimum(labels, neigh), p)
        if torch.equal(new, labels):
            break
        labels = new

    border = torch.where(edge & core[..., safe], labels[..., safe], _INT_INF).amin(-1)
    return _finalise(labels, border, core, valid, idx, max_clusters)
