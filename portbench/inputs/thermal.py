"""The MIBQAR fixture of thermal stand-in frames, ``portbench/data/
HISTORY_MIBQAR_thermal``: a keytrj-0 DL_POLY HISTORY of :data:`FRAMES`
frames, each the coordinates of ``tests/data/MIBQAR.pdb`` plus its own
Gaussian displacement of :data:`SIGMA_A` per atom and axis, drawn from
:data:`SEED`.  Atom keys are the PDB's element column (77-78).

The repository holds no MD trajectory of MIBQAR; framework atoms of a
MOF at room temperature have isotropic displacement parameters of
0.01-0.03 Å², an RMS of 0.1-0.17 Å per axis, so the frames differ as
thermal frames would, and no two escalate alike.  Not part of a
benchmark run: the file is committed, and

    python3 portbench/inputs/thermal.py

writes it again, byte for byte.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.inputs import fixtures, seeded  # noqa: E402

#: the structure the frames displace
PDB = ROOT / "tests" / "data" / "MIBQAR.pdb"
#: the fixture's name under ``portbench/data``
NAME = "HISTORY_MIBQAR_thermal"
FRAMES = 20
SIGMA_A = 0.1
SEED = 424


def frames(n: int = FRAMES, sigma: float = SIGMA_A, seed: int = SEED) -> tuple[np.ndarray, np.ndarray]:
    """(elements (atoms,), coordinates (n, atoms, 3) float64): MIBQAR.pdb's
    atoms, each frame displaced by its own draw."""
    lines = [ln for ln in PDB.read_text().splitlines() if ln[:6] in ("ATOM  ", "HETATM")]
    elements = np.array([fixtures.pdb_element(ln) for ln in lines])
    xyz = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in lines])
    moved = xyz[None] + seeded.rng(seed, 0).normal(0.0, sigma, size=(n, *xyz.shape))
    return elements, moved


def text(elements: np.ndarray, coords: np.ndarray) -> str:
    """The HISTORY of ``coords`` (frames, atoms, 3), coordinates as ``%12.4E``."""
    n = len(elements)
    out = ["MIBQAR thermal stand-in frames (portbench/inputs/thermal.py)", f"{0:10d}{0:10d}{n:10d}"]
    for k, frame in enumerate(coords):
        out.append(f"timestep{(k + 1) * 25:10d}{n:10d}{0:10d}{0:10d}{0.0007:12.6f}")
        for i, (el, (x, y, z)) in enumerate(zip(elements, frame)):
            out.append(f"{el:<8} {i + 1:9d}    1.000000    0.000000")
            out.append(f"{x:12.4E}{y:12.4E}{z:12.4E}")
    return "\n".join(out) + "\n"


def write(path: pathlib.Path = fixtures.DATA / NAME) -> pathlib.Path:
    """Write the fixture to ``path``."""
    path.write_text(text(*frames()))
    return path


if __name__ == "__main__":
    print(write())
