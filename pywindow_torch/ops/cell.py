"""Unit-cell helper used by the PDB reader (a copy of
``pywindow_tpu.ops.cell.unit_cell_to_lattice_array``)."""

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
