"""Output writers: PDB, XYZ, JSON (a copy of ``pywindow_tpu.io.outputs``;
the files they write are byte for byte the JAX package's, its PDB
REMARK line included, so either package reads what the other wrote).

Same fixed-column PDB layout and JSON conventions as the reference
(reference: io_tools.py:208-493).  Deviation, documented: the reference's
XYZ writer truncates coordinates to 2 decimals (io_tools.py:381); here
the default is 6 decimals with ``xyz_decimals=2`` available for
bit-compatible output.
"""

from __future__ import annotations

import json
import pathlib
from typing import Callable

import numpy as np

from pywindow_torch.io.forcefield import decipher_all


def to_list(obj):
    """JSON default: serialise numpy arrays (reference: utilities.py:72-77)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    msg = f"{type(obj)} is not JSON-serializable"
    raise TypeError(msg)


class NotADictionaryError(TypeError):
    """Raised when a dump helper receives a non-dict object
    (reference: io_tools.py:668)."""


class FileTypeError(ValueError):
    """Raised for an unsupported output extension
    (reference: io_tools.py:676)."""


def _check_override(filepath: pathlib.Path, override: bool) -> None:
    if not override and filepath.is_file():
        msg = (
            f"the file {filepath} already exists; use a different filepath "
            "or set override=True"
        )
        raise FileExistsError(msg)


class Output:
    """Write system dicts / properties to files
    (reference: io_tools.py:208-493)."""

    def dump2json(
        self,
        obj: dict,
        filepath: pathlib.Path | str,
        default: Callable = to_list,
        override: bool = False,
    ) -> None:
        """Write *obj* as JSON, appending ``.json`` when missing
        (reference: io_tools.py:215)."""
        if not isinstance(obj, dict):
            msg = "dump2json only accepts dictionaries"
            raise NotADictionaryError(msg)
        filepath = pathlib.Path(filepath)
        if ".json" not in filepath.name:
            filepath = filepath.with_suffix(".json")
        _check_override(filepath, override)
        with filepath.open("w+") as fh:
            json.dump(obj, fh, default=default)

    def dump2file(
        self,
        obj: dict,
        filepath: pathlib.Path | str,
        atom_ids_key: str = "atom_ids",
        override: bool = False,
        **kwargs,
    ) -> None:
        """Write a system dict to ``.pdb`` or ``.xyz`` by extension
        (reference: io_tools.py:240)."""
        filepath = pathlib.Path(filepath)
        _check_override(filepath, override)
        if filepath.suffix == ".pdb":
            self._save_pdb(
                obj, filepath, atom_ids_key=atom_ids_key, **kwargs
            )
        elif filepath.suffix == ".xyz":
            kwargs.pop("cryst", None)
            kwargs.pop("space_group", None)
            kwargs.pop("resname", None)
            kwargs.pop("chainid", None)
            kwargs.pop("resseq", None)
            self._save_xyz(obj, filepath, **kwargs)
        else:
            msg = (
                f"the {filepath.suffix} extension is not supported for "
                "dumping; use .xyz or .pdb"
            )
            raise FileTypeError(msg)

    def _save_xyz(
        self,
        system: dict,
        filepath: pathlib.Path | str,
        elements_key: str = "elements",
        coordinates_key: str = "coordinates",
        remarks=None,
        forcefield: str | None = None,
        decipher: bool = False,
        xyz_decimals: int = 6,
    ) -> None:
        filepath = pathlib.Path(filepath)
        if isinstance(remarks, (list, tuple)):
            remarks = ";".join(str(r) for r in remarks)
        elif remarks is None:
            remarks = ""
        elements = np.asarray(system[elements_key])
        coordinates = np.asarray(system[coordinates_key])
        if decipher:
            if forcefield is None:
                msg = "forcefield must be provided when decipher is True"
                raise ValueError(msg)
            elements = decipher_all(elements, forcefield)
        out = [f"{len(elements):0d}", str(remarks)]
        fmt = f"{{}} {{:.{xyz_decimals}f}} {{:.{xyz_decimals}f}} {{:.{xyz_decimals}f}}"
        for el, xyz in zip(elements, coordinates):
            out.append(fmt.format(el, *xyz))
        with filepath.open("w+") as fh:
            fh.write("\n".join(out) + "\n")

    def _save_pdb(
        self,
        system: dict,
        filepath: pathlib.Path | str,
        atom_ids_key: str = "atom_ids",
        elements_key: str = "elements",
        coordinates_key: str = "coordinates",
        remarks=None,
        cryst: str = "unit_cell",
        space_group: str | None = None,
        forcefield: str | None = None,
        decipher: bool = False,
        resname: str = "MOL",
        chainid: str = "A",
        resseq: int = 1,
    ) -> None:
        filepath = pathlib.Path(filepath)
        lines = ["REMARK File generated using pywindow_tpu."]
        if isinstance(remarks, (list, tuple)):
            lines.extend(f"REMARK {r}" for r in remarks)
        elif isinstance(remarks, (str, int, float)):
            lines.append(f"REMARK {remarks}")

        if cryst in system and np.asarray(system[cryst]).any():
            cell = np.asarray(system[cryst])
            cryst_line = "CRYST1" + "".join(
                f"{v:9.3f}" for v in cell[:3]
            ) + "".join(f"{v:7.2f}" for v in cell[3:])
            cryst_line = f"{cryst_line} {space_group or 'P1'}"
            lines.append(cryst_line)

        atom_ids = np.asarray(system[atom_ids_key])
        elements = np.asarray(system[elements_key])
        if decipher:
            if forcefield is None:
                msg = "forcefield must be provided when decipher is True"
                raise ValueError(msg)
            elements = decipher_all(elements, forcefield)
        coordinates = np.asarray(system[coordinates_key])

        resseq_s = str(resseq).rjust(4)
        for i in range(len(atom_ids)):
            x, y, z = coordinates[i]
            lines.append(
                f"ATOM  {i + 1:5d} {str(atom_ids[i]).center(4):4} "
                f"{resname:3} {chainid}{resseq_s}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}"
                f"{' '.center(22)}{str(elements[i]).rjust(2):2}  "
            )
        lines.append("END")
        if filepath.suffix != ".pdb":
            filepath = pathlib.Path(f"{filepath}.pdb")
        with filepath.open("w+") as fh:
            fh.write("\n".join(lines))
