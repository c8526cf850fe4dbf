"""Unit-cell helpers of the PDB reader and the DL_POLY trajectory
(copies of ``pywindow_tpu.ops.cell.unit_cell_to_lattice_array`` and
``lattice_array_to_unit_cell``)."""

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
