"""MD trajectories: DL_POLY HISTORY (counterpart of
``pywindow_tpu.trajectory``; reference: trajectory.py:103-833).

:class:`DLPOLY` maps a HISTORY file frame by frame (byte ranges, with
the integrity check at construction), decodes frames in pure Python
(the JAX package's fallback decoder, trajectory.py:1029-1196), and runs
``analysis_batched`` as device batches through
:mod:`pywindow_torch.parallel.batch`: frames that share one atom-id list
sweep in chunks with the per-atom fields moved to the device once.
Modular and rebuilt frames, autosave, exact per-frame sizes, XYZ and
PDB trajectories and the native decoders are not ported yet (ROADMAP
Q1.8-9).
"""

from __future__ import annotations

import pathlib
from contextlib import closing
from mmap import ACCESS_READ, mmap

import numpy as np
import torch

from pywindow_torch.config import resolve_device
from pywindow_torch.molecular import MolecularSystem
from pywindow_torch.ops.cell import lattice_array_to_unit_cell
from pywindow_torch.parallel import batch
from pywindow_torch.profiling import stage

#: frames per analyze_batch call on the generic (mixed atom ids) path
_GENERIC_BATCH = 256


class TrajectoryError(ValueError):
    """Corrupted or inconsistent trajectory file."""


def _not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(
        f"analysis_batched({option}) is not ported to pywindow_torch yet "
        "(ROADMAP Q1.8-9); use pywindow_tpu for it"
    )


class Trajectory:
    """Base trajectory: byte-mapped frames and batched analysis."""

    def __init__(self, filepath: pathlib.Path | str) -> None:
        self.filepath = pathlib.Path(filepath)
        self.filename = self.filepath.name
        self.system_id = self.filename.split(".")[0]
        self.frames: dict = {}
        self.analysis_output: dict = {}
        self.trajectory_map: dict = {}
        self.no_of_frames = 0

    # -- frame access ---------------------------------------------------

    def _decode_frame(self, frame: list) -> dict:
        raise NotImplementedError

    def _decode_raw(self, raw: str) -> dict:
        frame = [ln.split() for ln in raw.split("\n")][:-1]
        return self._decode_frame(frame)

    def _raw_frames(self, frame_nos: list[int]) -> list[dict]:
        """Decoded dicts of ``frame_nos``, read through one file map."""
        with (
            self.filepath.open() as fh,
            closing(mmap(fh.fileno(), 0, access=ACCESS_READ)) as mapped,
        ):
            out = []
            for f in frame_nos:
                start, end = self.trajectory_map[f]
                out.append(self._decode_raw(mapped[start:end].decode("utf-8")))
            return out

    def _system(self, raw: dict, frame_no, swap_atoms, forcefield) -> MolecularSystem:
        molsys = MolecularSystem.load_system(raw, "_".join([self.system_id, str(frame_no)]))
        if swap_atoms is not None:
            molsys.swap_atom_keys(swap_atoms)
        if forcefield is not None:
            molsys.decipher_atom_keys(forcefield)
        return molsys

    def _resolve_frames(self, frames) -> list[int]:
        if isinstance(frames, int):
            return [frames]
        if isinstance(frames, list):
            if any(not isinstance(f, int) for f in frames):
                msg = "the frames list must contain integers only"
                raise TypeError(msg)
            return list(frames)
        if isinstance(frames, tuple):
            if len(frames) != 2 or not all(isinstance(f, int) for f in frames):
                msg = "a frames tuple must hold exactly two integers (start, stop)"
                raise TypeError(msg)
            return list(range(frames[0], frames[1]))
        if isinstance(frames, str) and frames in ("all", "everything"):
            return list(range(self.no_of_frames))
        msg = f"unrecognised frames specification: {frames!r}"
        raise ValueError(msg)

    def get_frames(
        self,
        frames="all",
        override: bool = False,
        swap_atoms: dict | None = None,
        forcefield: str | None = None,
    ) -> dict:
        """Frame(s) as :class:`MolecularSystem` objects (reference:
        trajectory.py:112-212); bare frames are cached in ``frames``,
        processed ones (swap/decipher) are not."""
        if override:
            self.frames = {}
        todo = self._resolve_frames(frames)
        cacheable = swap_atoms is None and forcefield is None
        missing = [f for f in todo if not (cacheable and f in self.frames)]
        decoded = dict(zip(missing, self._raw_frames(missing)))
        collected = {}
        for f in todo:
            if cacheable and f in self.frames:
                collected[f] = self.frames[f]
                continue
            molsys = self._system(decoded[f], f, swap_atoms, forcefield)
            if cacheable:
                self.frames[f] = molsys
            collected[f] = molsys
        return collected

    # -- analysis ---------------------------------------------------------

    def analysis_batched(
        self,
        frames="all",
        batch_size: int | None = None,
        override: bool = False,
        modular: bool = False,
        rebuild: bool = False,
        swap_atoms: dict | None = None,
        forcefield: str | None = None,
        reference_max_diameter: float | None = None,
        autosave: pathlib.Path | str | None = None,
        exact_sizes: bool = False,
        device: torch.device | str = "cuda",
    ) -> None:
        """Analyse frames as device batches on ``device`` (the card unless
        the caller asks for the CPU); results land in
        :attr:`analysis_output` as ``{frame: {"0": properties}}``.

        Already-analysed frames are skipped unless ``override``.  Frames
        that share one atom-id list sweep in chunks of ``batch_size``
        (default: the largest memory-safe chunk) with one sampling-size
        pin, the largest frame's maximum diameter unless
        ``reference_max_diameter`` is given (the JAX package's contract:
        batched results differ from per-frame ones only through that
        pin).
        """
        for option, value in (
            ("modular=True", modular),
            ("rebuild=True", rebuild),
            ("exact_sizes=True", exact_sizes),
            ("autosave=...", autosave is not None),
        ):
            if value:
                raise _not_ported(option)
        device = resolve_device(device)
        todo = self._resolve_frames(frames)
        if not override:
            todo = [f for f in todo if f not in self.analysis_output]
        else:
            for f in todo:
                self.analysis_output.pop(f, None)
        if not todo:
            return

        with stage("trajectory_decode"):
            raws = self._raw_frames(todo)
        ids_key = "atom_ids" if "atom_ids" in raws[0] else "elements"
        ids0 = np.asarray(raws[0][ids_key])
        uniform = all(
            np.array_equal(np.asarray(r[ids_key]), ids0) for r in raws[1:]
        )

        def store(positions, results, n_atoms_of):
            for pos, props in zip(positions, results):
                props.pop("molecular_weight", None)
                props["no_of_atoms"] = n_atoms_of(pos)
                self.analysis_output.setdefault(todo[pos], {})["0"] = props

        if uniform:
            # one representative frame takes the swap/decipher semantics
            rep = self._system(
                {ids_key: ids0.copy(), "coordinates": raws[0]["coordinates"]},
                "sweep", swap_atoms, forcefield,
            )
            elements = np.asarray(rep.system_to_molecule().elements)
            coords = np.stack([np.asarray(r["coordinates"], np.float64) for r in raws])
            with stage("sweep_max_diameters"):
                maxd = batch.frame_max_diameters(elements, coords, device)
            batch.sweep_uniform(
                elements, coords, maxd,
                lambda positions, results: store(
                    positions.tolist(), results, lambda _: len(elements)
                ),
                batch_size=batch_size,
                reference_max_diameter=reference_max_diameter, device=device,
            )
            return

        systems = []
        for f, raw in zip(todo, raws):
            mol = self._system(raw, f, swap_atoms, forcefield).system_to_molecule()
            systems.append((mol.elements, mol.coordinates))
        ref = reference_max_diameter
        if ref is None:
            ref = batch._largest_exact_maxd(systems, device)
        size = batch_size or _GENERIC_BATCH
        for lo in range(0, len(systems), size):
            part = systems[lo : lo + size]
            results = batch.analyze_batch(
                part, reference_max_diameter=ref, device=device
            )
            store(
                range(lo, lo + len(part)), results,
                lambda pos: len(systems[pos][0]),
            )


class DLPOLY(Trajectory):
    """DL_POLY_C HISTORY trajectory (reference: trajectory.py:589-833).
    The integrity check runs at construction and raises
    :class:`TrajectoryError`."""

    IMCON = {
        0: "nonperiodic",
        1: "cubic",
        2: "orthorhombic",
        3: "parallelepiped",
        4: "truncated octahedral",
        5: "rhombic dodecahedral",
        6: "x-y parallelogram",
        7: "hexagonal prism",
    }
    KEYTRJ = {
        0: "coordinates",
        1: "coordinates and velocities",
        2: "coordinates, velocities and forces",
    }

    def __init__(self, filepath: pathlib.Path | str) -> None:
        super().__init__(filepath)
        self._check_history()
        self._map_history()

    def _map_history(self) -> None:
        """Byte-map every frame (reference: trajectory.py:647-689)."""
        self.trajectory_map = {}
        with (
            self.filepath.open() as fh,
            closing(mmap(fh.fileno(), 0, access=ACCESS_READ)) as mapped,
        ):
            progress = 0
            frame = 0
            frame_start = 0
            header_done = False
            while True:
                bline = mapped.readline()
                if len(bline) == 0:
                    self.trajectory_map[frame] = [frame_start, progress]
                    frame += 1
                    break
                sline = bline.decode("utf-8").split()
                if sline and sline[0] == "timestep":
                    if header_done:
                        self.trajectory_map[frame] = [frame_start, progress]
                        frame += 1
                    else:
                        self._decode_header(mapped[0:progress])
                        header_done = True
                    frame_start = progress
                progress += len(bline)
        self.no_of_frames = frame

    def _decode_header(self, raw: bytes) -> None:
        header = [ln.split() for ln in raw.decode("utf-8").split("\n")]
        keytrj, imcon, natms = (int(v) for v in header[1][:3])
        self.periodic_boundary = self.IMCON[imcon]
        self.content_type = self.KEYTRJ[keytrj]
        self.no_of_atoms = natms

    def _decode_frame(self, frame: list) -> dict:
        """Decode one HISTORY frame (reference: trajectory.py:712-766)."""
        info = {
            "nstep": int(frame[0][1]),
            "natms": int(frame[0][2]),
            "keytrj": int(frame[0][3]),
            "imcon": int(frame[0][4]),
            "tstep": float(frame[0][5]),
        }
        out: dict = {"frame_info": info}
        start = 1
        if info["imcon"] in (1, 2, 3):
            out["lattice"] = np.array(frame[1:4], dtype=float).T
            out["unit_cell"] = lattice_array_to_unit_cell(out["lattice"])
            start = 4
        stride = info["keytrj"] + 2
        body = frame[start:]
        out["atom_ids"] = np.array([body[i][0] for i in range(0, len(body), stride)])
        out["coordinates"] = np.array(
            [body[i] for i in range(1, len(body), stride)], dtype=float
        )
        if stride >= 3:
            out["velocities"] = np.array(
                [body[i] for i in range(2, len(body), stride)], dtype=float
            )
        if stride >= 4:
            out["forces"] = np.array(
                [body[i] for i in range(3, len(body), stride)], dtype=float
            )
        return out

    def _check_history(self) -> None:
        """Integrity check: monotone timesteps, no empty lines, header
        shape notes in ``check_log`` (reference: trajectory.py:768-833)."""
        self.check_log = ""
        line_no = 0
        timestep = 0
        with (
            self.filepath.open() as fh,
            closing(mmap(fh.fileno(), 0, access=ACCESS_READ)) as mapped,
        ):
            while True:
                bline = mapped.readline()
                if len(bline) == 0:
                    break
                line_no += 1
                sline = bline.decode("utf-8").strip("\n").split()
                if len(sline) == 0:
                    msg = f"Line {line_no}: the file contains an empty line"
                    raise TrajectoryError(msg)
                if line_no == 1 and sline[0] != "DLFIELD":
                    self.check_log += (
                        f"Line {line_no}: no comment line present as the "
                        "file header\n"
                    )
                if line_no == 2 and len(sline) != 3:
                    self.check_log += (
                        f"Line {line_no}: second header line (periodicity "
                        "/ trajectory type) is missing\n"
                    )
                if sline[0] == "timestep":
                    new_timestep = int(sline[1])
                    if timestep > new_timestep:
                        msg = f"Line {line_no}: the trajectory is discontinuous"
                        raise TrajectoryError(msg)
                    timestep = new_timestep
