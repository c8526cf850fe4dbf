"""The fixtures the inputs are made from, copied into ``portbench/data``
and read by plain parsers: the 20-frame CC3 DL_POLY HISTORY (pywindow's
``HISTORY_singlemol_short``) and the periodic cell of 8 CC3 cages
(pywindow's ``system_periodic.pdb``)."""

from __future__ import annotations

import functools
import pathlib

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


@functools.cache
def history(name: str) -> tuple[list[str], list[str], np.ndarray]:
    """(the two header lines, the atom record line of each atom, the
    coordinates (frames, atoms, 3) float64) of a keytrj-0 HISTORY."""
    lines = (DATA / name).read_text().splitlines()
    header = lines[:2]
    natms = int(lines[1].split()[2])
    starts = [i for i, ln in enumerate(lines) if ln.startswith("timestep")]
    atom_lines = [lines[starts[0] + 1 + 2 * a] for a in range(natms)]
    coords = np.array(
        [
            [[float(v) for v in lines[s + 2 + 2 * a].split()] for a in range(natms)]
            for s in starts
        ]
    )
    return header, atom_lines, coords


def atom_keys(atom_lines: list[str]) -> np.ndarray:
    """The atom keys (first field) of HISTORY atom record lines."""
    return np.array([ln.split()[0] for ln in atom_lines])


@functools.cache
def pdb_cell(name: str) -> tuple[str, list[str], np.ndarray, float]:
    """(the CRYST1 line, the ATOM/HETATM lines, their coordinates (N, 3)
    float64, the cubic cell edge) of a one-frame PDB."""
    lines = (DATA / name).read_text().splitlines()
    cryst = next(ln for ln in lines if ln.startswith("CRYST1"))
    atoms = [ln for ln in lines if ln[:6] in ("ATOM  ", "HETATM")]
    xyz = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atoms])
    a, b, c = (float(cryst[6:15]), float(cryst[15:24]), float(cryst[24:33]))
    if not a == b == c:
        msg = f"{name}: the generator takes a cubic cell, got {a}, {b}, {c}"
        raise ValueError(msg)
    return cryst, atoms, xyz, a


def pdb_element(line: str) -> str:
    """The element column (77-78) of an ATOM/HETATM line."""
    return line[76:78].strip()
