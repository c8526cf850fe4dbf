"""Unit-cell algebra: lattice matrices, fractional transforms, supercells
(a copy of ``pywindow_tpu.ops.cell``).

Host numpy: the periodic rebuild's seed ties depend on this exact
arithmetic (``docs/design.md:287-299``), so it stays as the JAX package
wrote it.  The reference converts coordinates one atom at a time
(reference: utilities.py:742-765); here each conversion is one matrix
product.
"""

from __future__ import annotations

import numpy as np


def unit_cell_to_lattice_array(cryst) -> np.ndarray:
    """(a, b, c, alpha, beta, gamma) -> 3x3 lattice (orthogonalisation)
    matrix, same row convention as the reference (utilities.py:653-690).
    """
    a, b, c, alpha, beta, gamma = np.asarray(cryst, dtype=np.float64)
    ra, rb, rg = np.deg2rad([alpha, beta, gamma])
    ca, cb, cg = np.cos([ra, rb, rg])
    sg = np.sin(rg)
    volume = a * b * c * np.sqrt(
        1.0 - ca * ca - cb * cb - cg * cg + 2.0 * ca * cb * cg
    )
    return np.array(
        [
            [a, b * cg, c * cb],
            [0.0, b * sg, c * (ca - cb * cg) / sg],
            [0.0, 0.0, volume / (a * b * sg)],
        ]
    )


def lattice_array_to_unit_cell(lattice: np.ndarray) -> np.ndarray:
    """3x3 lattice matrix -> (a, b, c, alpha, beta, gamma)
    (reference: utilities.py:693-709)."""
    lattice = np.asarray(lattice, dtype=np.float64)
    lengths = np.sqrt(np.sum(lattice**2, axis=0))
    gamma_r = np.arccos(lattice[0][1] / lengths[1])
    beta_r = np.arccos(lattice[0][2] / lengths[2])
    alpha_r = np.arccos(
        lattice[1][2] * np.sin(gamma_r) / lengths[2]
        + np.cos(beta_r) * np.cos(gamma_r)
    )
    angles = np.rad2deg([alpha_r, beta_r, gamma_r])
    return np.append(lengths, angles)


def volume_from_lattice_array(lattice: np.ndarray) -> float:
    """Unit-cell volume as the lattice-matrix determinant
    (reference: utilities.py:944)."""
    return float(np.linalg.det(np.asarray(lattice, dtype=np.float64)))


def volume_from_cell_parameters(cryst) -> float:
    """Unit-cell volume from (a, b, c, alpha, beta, gamma)
    (reference: utilities.py:953)."""
    return volume_from_lattice_array(unit_cell_to_lattice_array(cryst))


def cart_to_frac(coordinates: np.ndarray, lattice: np.ndarray) -> np.ndarray:
    """Cartesian -> fractional for (N, 3) or (3,) coordinates, batched."""
    inv = np.linalg.inv(np.asarray(lattice, dtype=np.float64))
    return np.asarray(coordinates) @ inv.T


def frac_to_cart(fractional: np.ndarray, lattice: np.ndarray) -> np.ndarray:
    """Fractional -> cartesian for (N, 3) or (3,) coordinates, batched."""
    return np.asarray(fractional) @ np.asarray(lattice, dtype=np.float64).T


def create_supercell(system: dict, supercell=None) -> dict:
    """Replicate a periodic system over integer lattice translations.

    Default is the 3x3x3 block of translations in [-1, 1]^3 used for
    periodic molecule reconstruction (reference: utilities.py:768-810).
    Returns a new system dict with replicated elements/atom_ids.
    """
    if supercell is None:
        supercell = [[-1, 1], [-1, 1], [-1, 1]]
    lattice = system.get("lattice")
    if lattice is None:
        lattice = unit_cell_to_lattice_array(system["unit_cell"])
    frac = cart_to_frac(system["coordinates"], lattice)
    shifts = np.array(
        [
            [a, b, c]
            for a in range(int(supercell[0][0]), int(supercell[0][1]) + 1)
            for b in range(int(supercell[1][0]), int(supercell[1][1]) + 1)
            for c in range(int(supercell[2][0]), int(supercell[2][1]) + 1)
        ],
        dtype=np.float64,
    )
    n_img = len(shifts)
    frac_all = (frac[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    out = {
        "elements": np.tile(np.asarray(system["elements"]), n_img),
        "coordinates": frac_to_cart(frac_all, lattice),
        "unit_cell": lattice_array_to_unit_cell(lattice),
        "lattice": np.asarray(lattice, dtype=np.float64),
    }
    if "atom_ids" in system:
        out["atom_ids"] = np.tile(np.asarray(system["atom_ids"]), n_img)
    return out
