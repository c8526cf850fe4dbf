"""The ``max_dim`` kernel: the maximum vdW-corrected diameter of each
frame (no counterpart kernel in ``pywindow_tpu``, which leaves
``geometry.max_dim`` and ``max_dim_value`` to XLA).

- :func:`max_dim_plain`, :func:`max_dim_value_plain`: the plain versions,
  all pairs at once as (..., N, N) tensors;
- :func:`max_dim_cuda`: the wrapper of ``csrc/max_dim.cu`` on flat
  (B, N) frames, both forms;
- :func:`max_dim`, :func:`max_dim_value`: the entry points
  (``geometry.max_dim`` and ``geometry.max_dim_value`` call them), by the
  device of ``mol.coords``, with no size gate and no fallback.  The
  kernel's outputs equal the plain versions' bit for bit.

:func:`max_dim_mirror` runs the kernel's algorithm on the CPU (its tiles,
the entries it visits, its order and its reductions in any order); the
tests hold it to the plain versions, the pipeline never calls it.
"""

from __future__ import annotations

import torch

from pywindow_torch.ops import _cuda
from pywindow_torch.ops.encoding import MolArrays
from pywindow_torch.ops.geometry import BIG, pairwise_distances

#: rows and columns of the kernel's pair tiles (``kTile`` in
#: ``csrc/max_dim.cu``)
TILE = 128
#: the largest atom axis the kernel takes: its flat indices i N + j are
#: 32-bit
MAX_ATOMS = 46340
#: the helper launch of one kernel call, after "max_dim" (the pair tiles):
#: one thread a frame over its tiles' partials
HELPER_KERNELS = ("max_dim_reduce",)


def max_dim_plain(mol: MolArrays) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Maximum vdW-corrected diameter and the two atoms realising it.

    Upper-triangle (diagonal included) argmax of
    ``dist(i,j) + vdw_i + vdw_j``, row-major first maximum, as ``np.triu``
    + ``argmax`` in the reference (utilities.py:355-372).
    """
    d = pairwise_distances(mol.coords, mol.coords)
    d = d + mol.vdw[..., :, None] + mol.vdw[..., None, :]
    n = mol.coords.shape[-2]
    idx = torch.arange(n, device=d.device)
    valid = (
        (idx[:, None] <= idx[None, :])
        & mol.mask[..., :, None]
        & mol.mask[..., None, :]
    )
    flat = torch.where(valid, d, -BIG).reshape(*d.shape[:-2], n * n)
    best = flat.argmax(-1)
    return best // n, best % n, flat.gather(-1, best[..., None])[..., 0]


def max_dim_value_plain(mol: MolArrays) -> torch.Tensor:
    """Maximum vdW-corrected diameter, value only (the full symmetric
    matrix has the same maximum as its upper triangle)."""
    d = pairwise_distances(mol.coords, mol.coords)
    d = d + mol.vdw[..., :, None] + mol.vdw[..., None, :]
    valid = mol.mask[..., :, None] & mol.mask[..., None, :]
    return torch.where(valid, d, -BIG).amax((-2, -1))


def max_dim_flat_plain(
    coords: torch.Tensor, vdw: torch.Tensor, mask: torch.Tensor, atoms: bool
) -> tuple:
    """The plain versions in :func:`max_dim_cuda`'s form: ``(value,
    atom_1, atom_2)`` with ``atoms``, else ``(value,)``."""
    mol = MolArrays(coords, vdw, vdw, vdw, mask)  # mass and cov unused
    if atoms:
        a1, a2, value = max_dim_plain(mol)
        return value, a1, a2
    return (max_dim_value_plain(mol),)


def pair_tiles(n: int, tile: int = TILE) -> list[tuple[int, int]]:
    """The kernel's tiles of an N-atom frame, in its block order: (r, c)
    with r <= c, row-major."""
    nt = -(-n // tile)
    return [(r, c) for r in range(nt) for c in range(r, nt)]


def max_dim_cuda(
    coords: torch.Tensor, vdw: torch.Tensor, mask: torch.Tensor, atoms: bool
) -> tuple:
    """:func:`max_dim_flat_plain` through the CUDA kernel
    (``csrc/max_dim.cu``): coords (B, N, 3), vdw (B, N) of one dtype
    (float32 or float64), mask (B, N) bool, all contiguous on one card.
    Two launches, counted under ``"max_dim"`` and ``"max_dim_reduce"``."""
    dtype = coords.dtype
    device = _cuda.check_inputs("max_dim", dtype, coords=coords, vdw=vdw, mask=mask)
    if coords.ndim != 3:
        msg = f"max_dim: coords must be (B, N, 3), got {tuple(coords.shape)}"
        raise ValueError(msg)
    b, n = coords.shape[:2]
    _cuda.check_shape("max_dim", coords, (b, n, 3), "coords")
    _cuda.check_shape("max_dim", vdw, (b, n), "vdw")
    _cuda.check_shape("max_dim", mask, (b, n), "mask")
    if mask.dtype != torch.bool:
        msg = f"max_dim: mask must be a bool tensor, got {mask.dtype}"
        raise TypeError(msg)
    if b == 0 or not 0 < n <= MAX_ATOMS:
        msg = f"max_dim: needs 1 or more frames of 1 to {MAX_ATOMS} atoms, got ({b}, {n})"
        raise ValueError(msg)
    parts = b * len(pair_tiles(n))
    if parts >= 2**31:
        msg = f"max_dim: {parts} tile blocks in one launch (kernel indices are 32-bit)"
        raise ValueError(msg)
    value = torch.empty(b, dtype=dtype, device=device)
    found = (
        tuple(torch.empty(b, dtype=torch.int64, device=device) for _ in range(2))
        if atoms else (None, None)
    )
    _cuda.load_extension().max_dim(
        coords, vdw, mask,
        torch.empty(parts, dtype=dtype, device=device),
        torch.empty(parts, dtype=torch.int32, device=device),
        value, *found,
    )
    _cuda.count_launch("max_dim")
    for key in HELPER_KERNELS:
        _cuda.count_launch(key)
    return (value, *found) if atoms else (value,)


def _frames(mol: MolArrays) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """coords, vdw and mask with the leading axes as one frame axis."""
    n = mol.mask.shape[-1]
    return mol.coords.reshape(-1, n, 3), mol.vdw.reshape(-1, n), mol.mask.reshape(-1, n)


def max_dim(mol: MolArrays) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(atom_1, atom_2, value) over the leading axes of ``mol``; see
    :func:`max_dim_plain`."""
    if _cuda.device_type("max_dim", mol.coords) == "cpu":
        return max_dim_plain(mol)
    lead = mol.mask.shape[:-1]
    value, a1, a2 = max_dim_cuda(*_frames(mol), True)
    return a1.reshape(lead), a2.reshape(lead), value.reshape(lead)


def max_dim_value(mol: MolArrays) -> torch.Tensor:
    """The value over the leading axes of ``mol``; see
    :func:`max_dim_value_plain`."""
    if _cuda.device_type("max_dim", mol.coords) == "cpu":
        return max_dim_value_plain(mol)
    return max_dim_cuda(*_frames(mol), False)[0].reshape(mol.mask.shape[:-1])


# -- the kernel's algorithm on the CPU -----------------------------------------


def above(v, k, bv, bk) -> torch.Tensor:
    """The kernel's argmax order, torch's own: is (v, k) above (bv, bk)?
    A NaN is above every number, equal values go to the smaller index."""
    nan, bnan = torch.isnan(v), torch.isnan(bv)
    return torch.where(nan, ~bnan | (k < bk), ~bnan & ((v > bv) | ((v == bv) & (k < bk))))


def _reduce(v: torch.Tensor, k: torch.Tensor, atoms: bool, order: torch.Tensor):
    """(B, E) candidates -> (B,) best, folded pairwise in the entry order
    ``order`` (a permutation of E): by :func:`above` with ``atoms``, else
    by the NaN-propagating maximum."""
    v, k = v[:, order], k[:, order]
    while v.shape[1] > 1:
        if v.shape[1] % 2:
            v = torch.cat([v, v[:, -1:]], 1)
            k = torch.cat([k, k[:, -1:]], 1)
        a, b = (v[:, 0::2], k[:, 0::2]), (v[:, 1::2], k[:, 1::2])
        take = above(*b, *a) if atoms else (b[0] > a[0]) | torch.isnan(b[0])
        v, k = torch.where(take, b[0], a[0]), torch.where(take, b[1], a[1])
    return v[:, 0], k[:, 0]


def max_dim_mirror(
    coords: torch.Tensor,
    vdw: torch.Tensor,
    mask: torch.Tensor,
    atoms: bool,
    tile: int = TILE,
    generator: torch.Generator | None = None,
) -> tuple:
    """:func:`max_dim_cuda`'s outputs by the kernel's algorithm on the
    CPU: the tiles of :func:`pair_tiles`, each visited entry's value as
    the kernel computes it (the atoms form: (d + vdw_i) + vdw_j, -1e30
    where a mask is off or i > j; the value form: both orders of each
    pair), the tiles' partials, then the frame's.  With ``generator`` the
    entries of a tile and the partials are folded in random orders, any
    of the kernel's reduction trees."""
    b, n = mask.shape
    partials = []
    for r, c in pair_tiles(n, tile):
        i = torch.arange(r * tile, min((r + 1) * tile, n))[:, None]
        j = torch.arange(c * tile, min((c + 1) * tile, n))[None, :]
        d = pairwise_distances(coords[:, i[:, 0]], coords[:, j[0]])
        vi, vj = vdw[:, i[:, 0], None], vdw[:, None, j[0]]
        ok = mask[:, i[:, 0], None] & mask[:, None, j[0]]
        if atoms:
            vals = [torch.where(ok & (i <= j), (d + vi) + vj, -BIG)]
            keys = [(i * n + j).expand_as(d)]
        else:
            vals = [torch.where(ok, (d + vi) + vj, -BIG), torch.where(ok, (d + vj) + vi, -BIG)]
            keys = [(i * n + j).expand_as(d), (j * n + i).expand_as(d)]
        v = torch.cat([x.reshape(b, -1) for x in vals], 1)
        k = torch.cat([x.reshape(b, -1) for x in keys], 1)
        partials.append(_reduce(v, k, atoms, _order(v.shape[1], generator)))
    v = torch.stack([p[0] for p in partials], 1)
    k = torch.stack([p[1] for p in partials], 1)
    value, key = _reduce(v, k, atoms, _order(v.shape[1], generator))
    return (value, key // n, key % n) if atoms else (value,)


def _order(e: int, generator: torch.Generator | None) -> torch.Tensor:
    return torch.arange(e) if generator is None else torch.randperm(e, generator=generator)
