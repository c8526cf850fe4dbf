"""The ``dbscan`` kernel (counterpart of ``pywindow_tpu.ops.cluster_pallas``).

:func:`dbscan` takes the plain version (:func:`pywindow_torch.ops.cluster.dbscan`)
for CPU tensors and the CUDA kernel (``csrc/dbscan.cu``) for CUDA
tensors, with no size gate and no fallback.  The kernel returns labels
only; ``n_clusters = max(labels) + 1`` equals the plain version's
``min(#components, max_clusters)`` because every component root carries
its own rank.  A frame's points, its eps-graph and its union-find live
in the block's shared memory (:func:`dbscan_smem_bytes`); only a K too
large for that (:func:`dbscan_route`) takes a global scratch of
:func:`dbscan_frame_bytes` a frame, allocated with the labels.

:func:`dbscan_mirror` runs the kernel's algorithm (order-preserving
compaction, each unordered pair tested once, union-find hooking the larger
root under the smaller, ranks from a prefix count of the roots) in torch
on the CPU, and :func:`dbscan_far_tiles` its rule for the tile pairs it
does not test; the tests hold them against the plain version and the JAX
package, the pipeline never calls them.
"""

from __future__ import annotations

import torch

from pywindow_torch.ops import _cuda
from pywindow_torch.ops import cluster as _cluster
from pywindow_torch.ops.geometry import sq_norm3

#: block widths of the kernel (threads a frame), widest first, with the
#: blocks of that width an H100 SM holds at once: one of 1,024 threads or
#: two of 512 at up to 64 registers a thread, six of 256 (compiled for
#: 42 registers a thread)
DBSCAN_WIDTHS = ((1024, 1), (512, 2), (256, 6))


def dbscan_threads(frames: int, sms: int) -> int:
    """Threads of the kernel's block (one frame): the widest of
    :data:`DBSCAN_WIDTHS` whose blocks hold the launch in one wave (one
    molecule: 1,024 threads on its SM), else 256: on a batch more frames
    in flight beat wider blocks (``ray_kernel_report.py``; PERF.md).  Any
    width gives the same labels."""
    for threads, per_sm in DBSCAN_WIDTHS[:-1]:
        if frames <= per_sm * sms:
            return threads
    return DBSCAN_WIDTHS[-1][0]


def dbscan_smem_bytes(k: int, element_size: int, stored: bool) -> int:
    """Shared memory of the kernel's block over K slots
    (``csrc/dbscan.cu``): the compacted points and each 32-point tile's
    box as (x, y, z, 0) records, the points' original indices and
    union-find parents, three words per tile (core bits, root bits, roots
    before), 32 warp counts and, when ``stored``, the ceil(K/32) x K-word
    eps-graph."""
    words = -(-k // 32)
    return (
        4 * (k + 2 * words) * element_size + 8 * k + 12 * words + 128
        + (4 * k * words if stored else 0)
    )


def dbscan_route(k: int, element_size: int) -> str:
    """Where the kernel keeps a frame of K slots: ``"stored"``, the
    eps-graph in shared memory (K up to 1,253 in float32, 1,194 in
    float64); ``"shared"``, pairs tested anew where they are needed, the
    rest in shared memory (up to K = 9,153 and 5,481); ``"global"``, the
    same with the frame's records in a global scratch (any larger K)."""
    if dbscan_smem_bytes(k, element_size, True) <= _cuda.SMEM_LIMIT:
        return "stored"
    if dbscan_smem_bytes(k, element_size, False) <= _cuda.SMEM_LIMIT:
        return "shared"
    return "global"


def dbscan_frame_bytes(k: int, element_size: int) -> int:
    """A frame's records in the ``"global"`` route's scratch: the
    unstored layout, rounded up to 256 bytes."""
    return -(-dbscan_smem_bytes(k, element_size, False) // 256) * 256


def dbscan_far_tiles(points: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """(T, T) bool: the pairs of 32-point tiles of one frame's compacted
    points (n, 3) that the kernel does not test, by its rule with its
    operations: the boxes' gap ``sqrt(gx^2 + gy^2 + gz^2)`` above
    ``eps + eps * 32u + tiny`` (``csrc/dbscan.cu`` derives it)."""
    n = points.shape[0]
    tiles = -(-n // 32)
    pad = torch.full((tiles * 32 - n, 3), torch.nan, dtype=points.dtype)
    blocks = torch.cat([points, pad]).reshape(tiles, 32, 3)
    lo = torch.where(torch.isnan(blocks), torch.inf, blocks).amin(1)
    hi = torch.where(torch.isnan(blocks), -torch.inf, blocks).amax(1)
    gap = torch.maximum(
        torch.maximum(lo[None, :] - hi[:, None], lo[:, None] - hi[None, :]), torch.zeros(())
    )
    g = torch.sqrt(
        gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] + gap[..., 2] * gap[..., 2]
    )
    slack = 32.0 * torch.finfo(points.dtype).eps / 2.0
    tiny = 1e-15 if points.dtype == torch.float32 else 1e-150
    return g > eps + eps * slack + tiny


def dbscan_labels_cuda(
    points: torch.Tensor,
    valid: torch.Tensor,
    eps: torch.Tensor,
    min_samples: int,
    max_clusters: int,
) -> torch.Tensor:
    """DBSCAN labels of a flat batch on the card: points (B, K, 3),
    valid (B, K) bool, eps (B,) -> (B, K) int32.  :func:`dbscan_threads`
    sets the block, :func:`dbscan_route` where the frame lives."""
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
    route = dbscan_route(k, points.element_size())
    scratch = None
    if route == "global":
        scratch = torch.empty(
            b * dbscan_frame_bytes(k, points.element_size()), dtype=torch.uint8, device=device
        )
    labels = torch.empty((b, k), dtype=torch.int32, device=device)
    _cuda.load_extension().dbscan(
        points, valid, eps, labels, int(min_samples), int(max_clusters),
        dbscan_threads(b, _cuda.sm_count(device)), route == "stored", scratch,
    )
    _cuda.count_launch("dbscan")
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


def _find(parent: list[int], x: int) -> int:
    while parent[x] != x:
        parent[x] = parent[parent[x]]  # path halving
        x = parent[x]
    return x


def dbscan_mirror(
    points: torch.Tensor,
    valid: torch.Tensor,
    eps: torch.Tensor,
    min_samples: int,
    max_clusters: int,
) -> torch.Tensor:
    """(B, K) int32 labels by the kernel's algorithm, frame by frame on the
    CPU: compact the valid points in order; test each unordered pair once
    (``sqrt(d^2) <= eps`` in difference form) and set both entries, except
    in the tile pairs of :func:`dbscan_far_tiles`; core points by neighbour
    count; union-find with every core point under the root of its least
    core neighbour's chain, then over the core-core edges i < j whose ends
    do not share a parent (nor is i j's), hooking the larger root under
    the smaller; a
    border point takes its least core neighbour's root; a root's rank is
    the count of roots up to it; ranks >= ``max_clusters`` fold to -1."""
    b, k = valid.shape
    out = torch.full((b, k), -1, dtype=torch.int32)
    eps = torch.as_tensor(eps, dtype=points.dtype).expand(b)
    inf = torch.iinfo(torch.int32).max
    for f in range(b):
        idx = torch.nonzero(valid[f]).flatten()
        n = idx.numel()
        if n == 0:
            continue
        pts = points[f, idx]
        tile = torch.arange(n) // 32
        near = ~dbscan_far_tiles(pts, eps[f])[tile[:, None], tile[None, :]]
        upper = torch.triu(torch.ones((n, n), dtype=torch.bool), 0)
        once = torch.sqrt(sq_norm3(pts[:, None, :] - pts[None, :, :])) <= eps[f]
        adj = ((once & upper) | (once & upper).T) & near
        core = adj.sum(-1) >= min_samples
        core_adj = adj & core[:, None] & core[None, :]
        first = torch.where(core_adj, torch.arange(n)[None, :], n).amin(-1)
        parent = torch.minimum(first, torch.arange(n)).tolist()
        parent = [_find(parent, i) for i in range(n)]
        for i, j in torch.nonzero(core_adj & upper).tolist():
            if i == j or parent[j] == i or parent[j] == parent[i]:
                continue
            ri, rj = _find(parent, i), _find(parent, j)
            if ri != rj:
                parent[max(ri, rj)] = min(ri, rj)
        root = torch.tensor([_find(parent, i) for i in range(n)])
        border = torch.where(adj & core[None, :], root[None, :], inf).amin(-1)
        raw = torch.where(core, root, border)
        is_root = core & (root == torch.arange(n))
        before = torch.cumsum(is_root.to(torch.int64), 0)  # roots up to each index
        rank = before[raw.clamp_max(n - 1)] - 1
        label = torch.where((raw == inf) | (rank >= max_clusters), -1, rank)
        out[f, idx] = label.to(torch.int32)
    return out
