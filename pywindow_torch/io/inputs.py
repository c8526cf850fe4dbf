"""Input readers: XYZ, PDB, MOL (V3000), RDKit.

Produce the system dict contract shared with the reference
(reference: io_tools.py:42-205): ``{"elements", "coordinates",
["atom_ids", "unit_cell", "lattice", "remarks"]}`` — plain numpy on the
host; device encoding happens later at the analysis boundary.
"""

from __future__ import annotations

import pathlib

import numpy as np

from pywindow_torch.ops.cell import unit_cell_to_lattice_array


class CorruptedFileError(ValueError):
    """Input file malformed (or is a trajectory — use the trajectory
    module)."""


class FileTypeError(ValueError):
    """Unsupported file extension."""


def read_xyz_lines(lines: list[str]) -> dict:
    """XYZ block -> system dict (reference: io_tools.py:106-127)."""
    try:
        body = lines[2:]
        elements = np.array([ln.split()[0] for ln in body])
        coordinates = np.array(
            [[float(x) for x in ln.split()[1:4]] for ln in body]
        )
        if coordinates.shape != (len(elements), 3):
            raise IndexError
    except (IndexError, ValueError):
        msg = (
            "corrupted XYZ file (empty trailing line, missing columns, or a "
            "trajectory — this reader takes one structure per file)"
        )
        raise CorruptedFileError(msg) from None
    return {"elements": elements, "coordinates": coordinates}


def read_pdb_lines(lines: list[str]) -> dict:
    """PDB block -> system dict, incl. CRYST1 -> unit_cell/lattice
    (reference: io_tools.py:129-183)."""
    if sum(ln.count("END ") for ln in lines) > 1:
        msg = (
            "multiple 'END' statements found in this PDB file; if it is a "
            "trajectory split it into frames, otherwise fix it"
        )
        raise CorruptedFileError(msg)
    system: dict = {}
    system["remarks"] = [ln for ln in lines if ln[:6] == "REMARK"]
    cryst = [
        float(ln[s:e])
        for ln in lines
        if ln[:6] == "CRYST1"
        for s, e in ((6, 15), (15, 24), (24, 33), (33, 40), (40, 47), (47, 54))
    ]
    system["unit_cell"] = np.array(cryst)
    if system["unit_cell"].any():
        system["lattice"] = unit_cell_to_lattice_array(system["unit_cell"])
    atoms = [ln for ln in lines if ln[:6] in ("HETATM", "ATOM  ")]
    system["atom_ids"] = np.array(
        [ln[12:16].strip() for ln in atoms], dtype="<U8"
    )
    system["elements"] = np.array(
        [ln[76:78].strip() for ln in atoms], dtype="<U8"
    )
    system["coordinates"] = np.array(
        [[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atoms]
    )
    return system


def read_mol_v3000_lines(lines: list[str]) -> dict:
    """MOL (V3000) block -> system dict (reference: io_tools.py:185-205)."""
    system: dict = {}
    if len(lines) > 2 and lines[2] != "\n":
        system["remarks"] = lines[2]
    elements: list[str] = []
    coordinates: list[list[str]] = []
    in_atoms = False
    for raw in lines:
        parts = raw.split()
        if len(parts) > 3:
            if parts[2] == "END" and parts[3] == "ATOM":
                in_atoms = False
            if in_atoms:
                elements.append(parts[3])
                coordinates.append(parts[4:7])
            if parts[2] == "BEGIN" and parts[3] == "ATOM":
                in_atoms = True
    system["elements"] = np.array(elements)
    system["coordinates"] = np.array(coordinates, dtype=float)
    return system


def read_mol2_lines(lines: list[str]) -> dict:
    """TRIPOS MOL2 block -> system dict.

    The reference reaches mol2 files only through RDKit
    (reference: examples/example_2.py:63 via ``Chem.MolFromMol2File``,
    then io_tools.py:80-104); this host parser covers the same inputs
    without the optional dependency.  Element symbols come from the
    SYBYL atom-type column (``N.2`` -> ``N``), which is what RDKit's
    Mol2 reader assigns as the atomic symbol.  All atoms are kept —
    RDKit's default hydrogen stripping is the caller's concern (see
    :func:`rdkit_like_mol`).
    """
    section = None
    elements: list[str] = []
    coordinates: list[list[float]] = []
    try:
        for raw in lines:
            s = raw.strip()
            if s.startswith("@<TRIPOS>"):
                section = s[len("@<TRIPOS>") :]
                continue
            if section == "ATOM" and s:
                parts = s.split()
                # atom_id atom_name x y z atom_type [subst_id subst charge]
                elements.append(parts[5].split(".")[0])
                coordinates.append([float(x) for x in parts[2:5]])
    except (IndexError, ValueError):
        raise CorruptedFileError("malformed @<TRIPOS>ATOM record") from None
    if not elements:
        msg = "no @<TRIPOS>ATOM records found in mol2 file"
        raise CorruptedFileError(msg)
    return {
        "elements": np.array(elements),
        "coordinates": np.array(coordinates, dtype=float),
    }


class _RdkitLikePosition:
    __slots__ = ("x", "y", "z")

    def __init__(self, xyz) -> None:
        self.x, self.y, self.z = (float(v) for v in xyz)


class _RdkitLikeAtom:
    __slots__ = ("_idx", "_symbol")

    def __init__(self, idx: int, symbol: str) -> None:
        self._idx = idx
        self._symbol = symbol

    def GetIdx(self) -> int:  # noqa: N802 - rdkit API casing
        return self._idx

    def GetSymbol(self) -> str:  # noqa: N802
        return self._symbol


class _RdkitLikeConformer:
    __slots__ = ("_coordinates",)

    def __init__(self, coordinates: np.ndarray) -> None:
        self._coordinates = coordinates

    def GetAtomPosition(self, idx: int) -> _RdkitLikePosition:  # noqa: N802
        return _RdkitLikePosition(self._coordinates[idx])


class _RdkitLikeMol:
    """Duck-typed stand-in for ``rdkit.Chem.Mol`` (read-only subset).

    Implements exactly the surface :meth:`Input.load_rdkit_mol` touches
    (reference io_tools.py:80-104): ``GetNumAtoms``, ``GetAtoms`` ->
    ``GetIdx``/``GetSymbol``, ``GetConformer`` -> ``GetAtomPosition``
    with ``.x/.y/.z``.
    """

    __slots__ = ("_elements", "_coordinates")

    def __init__(self, elements: np.ndarray, coordinates: np.ndarray) -> None:
        self._elements = elements
        self._coordinates = coordinates

    def GetNumAtoms(self) -> int:  # noqa: N802
        return len(self._elements)

    def GetAtoms(self):  # noqa: N802
        return [
            _RdkitLikeAtom(i, str(sym)) for i, sym in enumerate(self._elements)
        ]

    def GetConformer(self) -> _RdkitLikeConformer:  # noqa: N802
        return _RdkitLikeConformer(self._coordinates)


def rdkit_like_mol(system: dict, remove_hs: bool = True) -> _RdkitLikeMol:
    """Wrap a system dict as an RDKit-Mol-shaped object.

    ``remove_hs=True`` mirrors ``Chem.MolFromMol2File``'s default
    hydrogen stripping (the mode reference examples/example_2.py
    validates: 168-atom PUDXES.mol2 -> 84 heavy atoms).  Lets the
    RDKit input path run — and be tested — without rdkit installed.
    """
    elements = np.asarray(system["elements"])
    coordinates = np.asarray(system["coordinates"], dtype=float)
    if remove_hs:
        keep = np.array([str(e).upper() != "H" for e in elements])
        elements, coordinates = elements[keep], coordinates[keep]
    return _RdkitLikeMol(elements, coordinates)


class Input:
    """Load structures from files or RDKit molecules
    (reference: io_tools.py:42-104)."""

    _READERS = {
        ".xyz": read_xyz_lines,
        ".pdb": read_pdb_lines,
        ".mol": read_mol_v3000_lines,
        ".mol2": read_mol2_lines,
    }

    def load_file(self, filepath: pathlib.Path | str) -> dict:
        """Parse an ``.xyz``/``.pdb``/``.mol`` file into the system dict
        (``elements``, ``coordinates``, optional ``atom_ids``/``unit_cell``)
        (reference: io_tools.py:107)."""
        filepath = pathlib.Path(filepath)
        reader = self._READERS.get(filepath.suffix)
        if reader is None:
            msg = (
                f"unsupported input extension {filepath.suffix!r}; "
                "use .xyz, .pdb, .mol (V3000) or .mol2"
            )
            raise FileTypeError(msg)
        with filepath.open() as fh:
            lines = fh.readlines()
        return reader(lines)

    def load_rdkit_mol(self, mol) -> dict:
        """RDKit Mol -> system dict (reference: io_tools.py:80-104).

        RDKit itself is an optional dependency: only this entry point
        touches it, and only via the object the caller passed in.
        """
        n = mol.GetNumAtoms()
        elements = np.empty(n, dtype="<U8")
        coordinates = np.empty((n, 3))
        conf = mol.GetConformer()
        for atom in mol.GetAtoms():
            i = atom.GetIdx()
            elements[i] = atom.GetSymbol()
            pos = conf.GetAtomPosition(i)
            coordinates[i] = (pos.x, pos.y, pos.z)
        return {"elements": elements, "coordinates": coordinates}
