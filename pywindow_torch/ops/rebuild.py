"""Discrete-molecule extraction and periodic reconstruction
(counterpart of ``pywindow_tpu.ops.rebuild``; host numpy and the native
BFS core, kept off the card: moving it would break the ordering parity).

The reference's ``discrete_molecules`` (reference: utilities.py:820-1085)
is a Python BFS over nested lists with O(N) list membership tests — its
own docstring calls it the trajectory bottleneck (trajectory.py:27-30).
Two implementations here:

* :func:`discrete_molecules` — **exact parity**: the same BFS in the same
  discovery order (same molecule ordering, same atom ordering inside each
  molecule, same pseudo-origin tie-breaking), but with per-level
  vectorised numpy distance tests instead of per-atom Python loops.
  This is what tests and default rebuilds use.
* :func:`connected_components_fast` — an order-normalised union-find over
  the blocked pairwise bond graph, for throughput paths where reference
  atom ordering is irrelevant (per-frame trajectory rebuilds).

Bond criterion (both): ``Rcov(i) + Rcov(j) - tol < r_ij < Rcov(i) +
Rcov(j) + tol`` with tol = 0.4 A (utilities.py:833-838).
"""

from __future__ import annotations

import numpy as np

from pywindow_torch import native, tables
from pywindow_torch.profiling import METRICS, stage
from pywindow_torch.ops.cell import (
    cart_to_frac,
    unit_cell_to_lattice_array,
)

#: terminal atoms: absorbed into molecules but never expanded
#: (reference: utilities.py:933).
TERMINAL = frozenset(
    ["H", "CL", "BR", "F", "HE", "AR", "NE", "KR", "XE", "RN"]
)


def _system_arrays(system: dict):
    elements = np.asarray(system["elements"])
    coordinates = np.round(
        np.asarray(system["coordinates"], dtype=np.float64), 8
    )
    atom_ids = (
        np.asarray(system["atom_ids"]) if "atom_ids" in system else None
    )
    return elements, atom_ids, coordinates


def _pick_mode(system: dict, rebuild: dict | None) -> int:
    if rebuild is not None:
        return 3
    if "unit_cell" in system:
        return 2 if np.asarray(system["unit_cell"]).shape == (6,) else 1
    if "lattice" in system:
        return 2 if np.asarray(system["lattice"]).shape == (3, 3) else 1
    return 1


def _center_of_mass(elements: np.ndarray, coords: np.ndarray) -> np.ndarray:
    m = tables.ELEMENT_MASS[tables.element_ids(elements)]
    return (coords * m[:, None]).sum(axis=0) / m.sum()


def _sklearn_dist_to_point(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Distances from rows of ``x`` to point ``y``, in sklearn's exact
    ``euclidean_distances`` arithmetic (gram-matrix form, same operation
    order).  The reference's seed selection argmin ties at the 1e-15
    level in symmetric systems, so bitwise-identical arithmetic is the
    only way to reproduce its deterministic ordering
    (reference: utilities.py:958-964)."""
    xx = np.einsum("ij,ij->i", x, x)[:, np.newaxis]
    yy = np.einsum("ij,ij->i", y.reshape(1, -1), y.reshape(1, -1))[
        np.newaxis, :
    ]
    d2 = -2.0 * np.dot(x, y.reshape(-1, 1))
    d2 += xx
    d2 += yy
    np.maximum(d2, 0.0, out=d2)
    return np.sqrt(d2).ravel()


def discrete_molecules(
    system: dict,
    rebuild: dict | None = None,
    tol: float = 0.4,
    use_native: bool = True,
) -> list[dict]:
    """Split a system into bonded molecules, reference-identical ordering.

    With ``rebuild`` (a 3x3x3 supercell of the system), molecules crossing
    the periodic boundary are completed from supercell images and only
    those whose fractional COM falls inside the home cell are kept
    (boundary [0,1), or [-0.5,0.5) when the whole system is centred at
    the origin — reference: utilities.py:891-923, :1066-1084).

    ``use_native`` runs each molecule's BFS in the native core
    (:func:`pywindow_torch.native.bfs_molecule`, built at first use; a
    failed build raises), over one bin index of the call's coordinates,
    so each expanded atom tests only its neighbours' bins (the tests
    made are counted as ``rebuild_bfs_pairs`` while profiling is on);
    ``use_native=False`` runs the numpy BFS, its plain version.  Both
    give the same molecules in the same order.  A system with two atoms
    of identical value (element, id and coordinates) takes the numpy BFS
    either way: the native core's value interning needs unique keys.
    """
    mode = _pick_mode(system, rebuild)
    if "elements" not in system:
        msg = (
            "the 'elements' key is missing from the system dictionary; "
            "decipher the force-field atom keys first (see manual)"
        )
        raise KeyError(msg)
    elements, atom_ids, coords = _system_arrays(system)
    n = len(elements)
    cov = tables.ELEMENT_COV[tables.element_ids(elements)]
    heavy = np.array([e.upper() not in TERMINAL for e in elements])

    matrix = None
    boundary = None
    if mode in (2, 3):
        origin = np.array([0.01, 0.0, 0.0])
        matrix = (
            np.asarray(system["lattice"], dtype=np.float64)
            if "lattice" in system
            else unit_cell_to_lattice_array(system["unit_cell"])
        )
        # exact reference arithmetic (matrix @ column vector,
        # utilities.py:732-739) — the pseudo-origin feeds tie-sensitive
        # seed argmins.
        pseudo_origin = (
            matrix @ np.array([0.26, 0.25, 0.25]).reshape(-1, 1)
        ).ravel()
        system_com = _center_of_mass(elements, coords)
        boundary = (
            np.array([-0.5, 0.5])
            if np.allclose(system_com, origin, atol=1.0)
            else np.array([0.0, 1.0])
        )
    else:
        pseudo_origin = _center_of_mass(elements, coords) + np.array(
            [0.01, 0.0, 0.0]
        )

    if rebuild is not None:
        s_elements, s_atom_ids, s_coords = _system_arrays(rebuild)
        s_cov = tables.ELEMENT_COV[tables.element_ids(s_elements)]
        s_heavy = np.array(
            [e.upper() not in TERMINAL for e in s_elements]
        )
        # a supercell atom is "already in the unit-cell list" iff an
        # unassigned unit-cell atom matches it by value (coords rounded
        # to 8 dp, reference: utilities.py:1021).  With exact image
        # copies this reduces to coordinate identity.
        s_key = {}
        with stage("rebuild_intern"):
            for j in range(len(s_elements)):
                key = (
                    s_elements[j],
                    None if s_atom_ids is None else s_atom_ids[j],
                    s_coords[j, 0],
                    s_coords[j, 1],
                    s_coords[j, 2],
                )
                s_key.setdefault(key, []).append(j)

    max_r_cov = max(
        tables.atomic_covalent_radius[e.upper()] for e in set(elements)
    )
    max_dist = 2 * max_r_cov + tol

    def atom_key(idx, sup=False):
        if sup:
            return (
                s_elements[idx],
                None if s_atom_ids is None else s_atom_ids[idx],
                s_coords[idx, 0],
                s_coords[idx, 1],
                s_coords[idx, 2],
            )
        return (
            elements[idx],
            None if atom_ids is None else atom_ids[idx],
            coords[idx, 0],
            coords[idx, 1],
            coords[idx, 2],
        )

    unassigned = np.ones(n, dtype=bool)
    molecules: list[dict] = []

    # --- native-core preparation (value-identity key interning) -------
    native_ctx = None
    if use_native:
        with stage("rebuild_intern"):
            key_of: dict = {}

            def intern(el, aid, xyz):
                k = (el, aid, xyz[0], xyz[1], xyz[2])
                return key_of.setdefault(k, len(key_of)), k

            key_id = np.empty(n, dtype=np.int64)
            unit_by_key: dict = {}
            dup_keys = False
            for i in range(n):
                kid, k = intern(
                    elements[i],
                    None if atom_ids is None else atom_ids[i],
                    coords[i],
                )
                key_id[i] = kid
                if k in unit_by_key:
                    dup_keys = True
                unit_by_key[k] = i
            skey_id = smatch = None
            if rebuild is not None:
                ns = len(s_elements)
                skey_id = np.empty(ns, dtype=np.int64)
                smatch = np.full(ns, -1, dtype=np.int64)
                for j in range(ns):
                    kid, k = intern(
                        s_elements[j],
                        None if s_atom_ids is None else s_atom_ids[j],
                        s_coords[j],
                    )
                    skey_id[j] = kid
                    if k in unit_by_key:
                        smatch[j] = unit_by_key[k]
            if not dup_keys:  # duplicate-value atoms need the full scan
                native_ctx = {
                    "key_id": key_id,
                    "skey_id": skey_id,
                    "smatch": smatch,
                    "heavy_u8": heavy.astype(np.uint8),
                    "sheavy_u8": (
                        s_heavy.astype(np.uint8)
                        if rebuild is not None
                        else None
                    ),
                    "index": None,
                }

    while unassigned.any():
        cand = unassigned & heavy
        if not cand.any():
            break
        d0 = _sklearn_dist_to_point(coords[cand], pseudo_origin)
        seed = np.flatnonzero(cand)[np.argmin(d0)]

        if native_ctx is not None:
            un_u8 = unassigned.astype(np.uint8)
            with stage("rebuild_bfs"):
                if native_ctx["index"] is None:  # once a call, in its first span
                    native_ctx["index"] = native.BinIndex(
                        coords, s_coords if rebuild is not None else None, max_dist
                    )
                src_arr, idx_arr, pairs = native.bfs_molecule(
                    int(seed),
                    un_u8,
                    coords,
                    cov,
                    native_ctx["heavy_u8"],
                    native_ctx["key_id"],
                    s_coords if rebuild is not None else None,
                    s_cov if rebuild is not None else None,
                    native_ctx["sheavy_u8"],
                    native_ctx["skey_id"],
                    native_ctx["smatch"],
                    max_dist,
                    tol,
                    index=native_ctx["index"],
                )
            METRICS.count("rebuild_bfs_pairs", pairs)
            unassigned[:] = un_u8.astype(bool)
            with stage("rebuild_assemble"):
                mol_entries = [
                    ("u" if s == 0 else "s", int(i))
                    for s, i in zip(src_arr, idx_arr)
                ]
                mol = _assemble_molecule(
                    mol_entries, elements, atom_ids, coords,
                    s_elements if rebuild is not None else None,
                    s_atom_ids if rebuild is not None else None,
                    s_coords if rebuild is not None else None,
                )
                if _keep_molecule(mol, rebuild, matrix, boundary):
                    molecules.append(mol)
            continue

        # BFS.  Each frontier entry is (source, index) with source 'u'
        # (unit cell) or 's' (supercell); discovery order must match the
        # reference exactly (unit-cell neighbours of each frontier atom
        # first, then supercell neighbours, frontier processed in order).
        mol_entries: list[tuple[str, int]] = []
        in_molecule: set = set()
        frontier: list[tuple[str, int]] = [("u", seed)]
        in_frontier = {atom_key(seed)}
        unassigned[seed] = False

        while frontier:
            next_frontier: list[tuple[str, int]] = []
            next_keys: set = set()
            # mirror of the reference: atoms leave the unassigned pool
            # (atom_list) only *after* the whole frontier is processed
            # (utilities.py:1037-1039), so intra-frontier neighbour tests
            # still see other frontier members.
            level_pool = unassigned.copy()
            for src, idx in frontier:
                if src == "u":
                    level_pool[idx] = True
            for src, idx in frontier:
                el = elements[idx] if src == "u" else s_elements[idx]
                pos = coords[idx] if src == "u" else s_coords[idx]
                rc = cov[idx] if src == "u" else s_cov[idx]
                mol_entries.append((src, idx))
                if el.upper() in TERMINAL:
                    continue
                pool = level_pool.copy()
                if src == "u":
                    pool[idx] = False  # self-distance guard (> 0.1)
                cand_idx = np.flatnonzero(pool)
                if cand_idx.size:
                    d = np.linalg.norm(coords[cand_idx] - pos, axis=1)
                    near = (d > 0.1) & (d < max_dist)
                    rcv = rc + cov[cand_idx[near]]
                    bonded = cand_idx[near][
                        (rcv - tol < d[near]) & (d[near] < rcv + tol)
                    ]
                    for j in bonded:
                        k = atom_key(j)
                        if k not in in_frontier and k not in next_keys:
                            next_frontier.append(("u", j))
                            next_keys.add(k)
                if rebuild is not None:
                    d = np.linalg.norm(s_coords - pos, axis=1)
                    near = (d > 0.1) & (d < max_dist)
                    rcv = rc + s_cov[near]
                    hits = np.flatnonzero(near)[
                        (rcv - tol < d[near]) & (d[near] < rcv + tol)
                    ]
                    for j in hits:
                        k = atom_key(j, sup=True)
                        # skip supercell images that coincide with a
                        # *currently unassigned* unit-cell atom (they
                        # will be found through the unit-cell pool).
                        if _matches_unassigned(
                            k, s_key, unassigned, atom_key, elements,
                            atom_ids, coords,
                        ):
                            continue
                        if (
                            k not in in_frontier
                            and k not in next_keys
                            and k not in in_molecule
                        ):
                            next_frontier.append(("s", j))
                            next_keys.add(k)
            for src, idx in frontier:
                in_molecule.add(
                    atom_key(idx) if src == "u" else atom_key(idx, sup=True)
                )
                if src == "u":
                    unassigned[idx] = False
            # transfer only atoms not already collected
            frontier = [
                (src, j)
                for (src, j) in next_frontier
                if (atom_key(j) if src == "u" else atom_key(j, sup=True))
                not in in_molecule
            ]
            in_frontier = {
                atom_key(j) if src == "u" else atom_key(j, sup=True)
                for src, j in frontier
            }
            for src, j in frontier:
                if src == "u":
                    unassigned[j] = False

        mol = _assemble_molecule(
            mol_entries, elements, atom_ids, coords,
            s_elements if rebuild is not None else None,
            s_atom_ids if rebuild is not None else None,
            s_coords if rebuild is not None else None,
        )
        if _keep_molecule(mol, rebuild, matrix, boundary):
            molecules.append(mol)
    return molecules


def _assemble_molecule(
    mol_entries, elements, atom_ids, coords, s_elements, s_atom_ids,
    s_coords,
) -> dict:
    mol_elements = np.array(
        [
            elements[i] if src == "u" else s_elements[i]
            for src, i in mol_entries
        ],
        dtype="str",
    )
    mol_coords = np.array(
        [
            coords[i] if src == "u" else s_coords[i]
            for src, i in mol_entries
        ]
    )
    out = {"elements": mol_elements, "coordinates": mol_coords}
    if atom_ids is not None:
        out["atom_ids"] = np.array(
            [
                atom_ids[i] if src == "u" else s_atom_ids[i]
                for src, i in mol_entries
            ],
            dtype="str",
        )
    return out


def _keep_molecule(mol: dict, rebuild, matrix, boundary) -> bool:
    if rebuild is None:
        return True
    com = _center_of_mass(mol["elements"], mol["coordinates"])
    com_frac = np.around(cart_to_frac(com, matrix), 8)
    return bool(
        np.all((com_frac >= boundary[0]) & (com_frac < boundary[1]))
    )


def _matches_unassigned(
    key, s_key, unassigned, atom_key_fn, elements, atom_ids, coords
):
    """True iff a value-identical atom is still in the unassigned
    unit-cell pool (the reference's ``satom_list[j] in atom_list`` test,
    utilities.py:1021)."""
    # value identity with a unit-cell atom happens only for the identity
    # translation image; scan unassigned atoms at the same coordinates.
    el, aid, x, y, z = key
    idx = np.flatnonzero(unassigned)
    if not idx.size:
        return False
    same = (
        (coords[idx, 0] == x)
        & (coords[idx, 1] == y)
        & (coords[idx, 2] == z)
    )
    for j in idx[same]:
        if elements[j] == el and (
            atom_ids is None or atom_ids[j] == aid
        ):
            return True
    return False


def connected_components_fast(
    system: dict,
    tol: float = 0.4,
) -> np.ndarray:
    """Vectorised bond-graph connected components (no PBC rebuild).

    Returns an (N,) int label array; ordering is by component discovery
    over ascending atom index (NOT reference BFS order — use
    :func:`discrete_molecules` when reference-identical ordering is
    required).
    """
    elements, _, coords = _system_arrays(system)
    n = len(elements)
    cov = tables.ELEMENT_COV[tables.element_ids(elements)]
    diff = coords[:, None, :] - coords[None, :, :]
    d = np.sqrt((diff * diff).sum(-1))
    rsum = cov[:, None] + cov[None, :]
    bonded = (d > 0.1) & (d > rsum - tol) & (d < rsum + tol)
    # terminal atoms bond but do not expand: make their rows one-way.
    heavy = np.array([e.upper() not in TERMINAL for e in elements])
    bonded &= heavy[:, None] | heavy[None, :]

    labels = np.full(n, -1, dtype=np.int64)
    current = 0
    # only heavy atoms seed components (the reference drops leftover
    # terminal-only remainders, utilities.py:944-981); terminal atoms are
    # absorbed but never expanded.
    for i in range(n):
        if labels[i] >= 0 or not heavy[i]:
            continue
        stack = [i]
        labels[i] = current
        while stack:
            j = stack.pop()
            if not heavy[j]:
                continue
            for k in np.flatnonzero(bonded[j]):
                if labels[k] < 0:
                    labels[k] = current
                    stack.append(k)
        current += 1
    return labels
