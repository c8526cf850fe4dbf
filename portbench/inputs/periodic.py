"""A seeded periodic PDB trajectory: every frame is the fixture's cubic
cell translated by its own vector uniform in the cell, with every atom
wrapped back into it, written in the file's fixed columns (``%8.3f``),
frames separated by ``END``."""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from portbench.inputs import fixtures, seeded


@dataclasses.dataclass(frozen=True)
class Periodic:
    """A written trajectory: its path, the atom names (columns 13-16),
    the coordinates as written (frames, atoms, 3) float64, the cell edge
    and each frame's translation."""

    path: pathlib.Path
    names: np.ndarray
    coords: np.ndarray
    edge: float
    shifts: np.ndarray


def write(path: pathlib.Path, n_frames: int, seed: int, fixture: str) -> Periodic:
    """Write ``n_frames`` translated and wrapped copies of ``fixture``."""
    cryst, atoms, xyz, edge = fixtures.pdb_cell(fixture)
    shifts = seeded.rng(seed, 2).uniform(0.0, edge, size=(n_frames, 3))
    # printed to 3 decimals: a value that rounds up to the edge prints as
    # the edge, which the program and the reference both read as written
    printed = np.round(np.mod(xyz[None] + shifts[:, None], edge), 3)
    heads = [ln[:30] for ln in atoms]
    tails = [ln[54:] for ln in atoms]
    with path.open("w") as fh:
        for frame in printed:
            body = [
                f"{h}{x:8.3f}{y:8.3f}{z:8.3f}{t}" for h, (x, y, z), t in zip(heads, frame, tails)
            ]
            fh.write("\n".join([cryst, *body, "END"]) + "\n")
    names = np.array([ln[12:16].strip() for ln in atoms])
    return Periodic(path=path, names=names, coords=printed, edge=edge, shifts=shifts)
