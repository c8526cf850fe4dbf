"""The reference's own preparation of the molecules the program is given:
atom keys to elements, the maximum diameters that pin a sweep's sampling
sizes, and a plain rebuild of the cages of a periodic frame."""

from __future__ import annotations

import collections

import numpy as np
import torch

from portbench.reference.frozen import forcefield, tables

#: added to the sum of two covalent radii for a bond (the reference's
#: default bond tolerance)
BOND_TOL = 0.4


def elements(keys, swap: dict | None, field: str | None) -> np.ndarray:
    """The element of each atom key: ``swap`` first, then the force
    field's notation."""
    arr = np.asarray(keys, dtype="<U8").copy()
    for key, value in (swap or {}).items():
        arr[arr == key] = value
    return forcefield.decipher_all(arr, field) if field else arr


def max_diameters(elements_: np.ndarray, coords: np.ndarray, device, block: int = 256) -> np.ndarray:
    """Each frame's vdW-corrected maximum diameter (frames, atoms, 3) ->
    (frames,), in float64 on ``device``."""
    vdw = torch.as_tensor(tables.ELEMENT_VDW[tables.element_ids(elements_)], device=device)
    pair = vdw[:, None] + vdw[None, :]
    out = []
    for lo in range(0, len(coords), block):
        c = torch.as_tensor(coords[lo : lo + block], dtype=torch.float64, device=device)
        d = torch.sqrt(((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)) + pair
        out.append(d.amax((-2, -1)).cpu())
    return torch.cat(out).numpy()


def rebuild(elements_: np.ndarray, coords: np.ndarray, edge: float) -> list[tuple[np.ndarray, np.ndarray]]:
    """The whole molecules of one frame of a cubic cell: atoms bonded
    across the boundary by their minimum image (covalent radii plus
    :data:`BOND_TOL`), each molecule laid out from its lowest atom by a
    breadth-first walk over its bonds, in atom order."""
    cov = tables.ELEMENT_COV[tables.element_ids(elements_)]
    x = np.asarray(coords, np.float64)
    d = x[:, None, :] - x[None, :, :]
    d -= edge * np.round(d / edge)
    bonded = np.sqrt((d * d).sum(-1)) < cov[:, None] + cov[None, :] + BOND_TOL
    np.fill_diagonal(bonded, False)
    placed = np.full(len(x), False)
    whole = x.copy()
    out = []
    for root in range(len(x)):
        if placed[root]:
            continue
        placed[root] = True
        members, queue = [root], collections.deque([root])
        while queue:
            i = queue.popleft()
            for j in np.flatnonzero(bonded[i] & ~placed):
                placed[j] = True
                whole[j] = whole[i] + d[j, i]
                members.append(j)
                queue.append(j)
        idx = np.sort(np.array(members))
        out.append((elements_[idx], whole[idx]))
    return out
