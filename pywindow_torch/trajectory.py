"""MD trajectories: DL_POLY HISTORY, XYZ and PDB (counterpart of
``pywindow_tpu.trajectory``; reference: trajectory.py:103-1045).

Each trajectory byte-maps its frames at construction (DL_POLY with the
integrity check) and decodes frames on the host: through the native
library (:mod:`pywindow_torch.native`) unless it was opened with
``use_native=False``, which takes the Python map and decoders, their
plain versions.  ``analysis_batched`` runs the frames as device batches
through :mod:`pywindow_torch.parallel.batch`:

- frames that share one atom-id list (and are not split into molecules)
  stream: slab k+1 decodes in one threaded native pass (the GIL
  released) while the device runs chunk k, the per-atom fields move to
  the device once, and the chunks' results are collected on a thread
  (:func:`~pywindow_torch.parallel.batch.sweep_stream`); a slab whose
  atom ids diverge from the first frame's, or that does not parse,
  sends the frames to the generic path (:class:`SweepDecodeError`);
- modular frames (``modular=True``, optionally ``rebuild=True`` for
  periodic cells) and frames whose atom ids vary take the generic path:
  chunks of frames, each frame split into its molecules on the host, the
  molecules dispatched in buckets of one padded atom count under one
  sampling pin, the saturated ones re-run before anything is recorded;
- ``exact_sizes`` buckets frames by their own sampling sizes, so the
  batched results equal the serial ones; it, and ``use_native=False``,
  decode every frame before the first chunk
  (:func:`~pywindow_torch.parallel.batch.sweep_uniform`).

Results land in ``analysis_output`` as ``{frame: {molecule key:
properties}}`` (key ``"0"`` for a whole frame, the ints of
``make_modular`` for molecules).

Fixed reference quirks, as in the JAX package: tuple frame ranges work,
``make_supercell`` uses ``supercell[2]`` for the c direction, and a
PDB trajectory's CRYST1 lines become a lattice, so its frames rebuild.
"""

from __future__ import annotations

import gc
import json
import pathlib
from contextlib import closing
from mmap import ACCESS_READ, mmap

import numpy as np
import torch

from pywindow_torch import native, profiling, tables
from pywindow_torch.config import DEFAULT_CONFIG, pad_multiple
from pywindow_torch.io.outputs import Output, to_list
from pywindow_torch.molecular import MolecularSystem
from pywindow_torch.ops.analysis import max_dim_bound, max_dim_host, static_sizes
from pywindow_torch.ops.cell import (
    create_supercell,
    lattice_array_to_unit_cell,
    unit_cell_to_lattice_array,
)
from pywindow_torch.ops.encoding import round_up
from pywindow_torch.parallel import batch
from pywindow_torch.parallel.mesh import DeviceSpec, frame_devices
from pywindow_torch.profiling import stage

#: frames per chunk on the generic path (bounds decoded-frame memory)
_GENERIC_BATCH = 256
#: frames the exact-sizes pre-scan keeps decoded for the sweep; above it
#: the sweep decodes them again
_FRAME_CACHE_LIMIT = 4096


class TrajectoryError(ValueError):
    """Corrupted or inconsistent trajectory file."""


class SweepDecodeError(RuntimeError):
    """A slab of the streamed sweep did not decode: a frame does not
    parse, or its atom ids diverge from the first frame's.  The sweep's
    frames then take the generic per-frame path."""


def make_supercell(system: dict, supercell=None) -> MolecularSystem:
    """Expand a unit cell into a supercell :class:`MolecularSystem` of
    ``supercell`` = [na, nb, nc] cells (reference: trajectory.py:75-100,
    with its c-axis bug fixed)."""
    if supercell is None:
        supercell = [1, 1, 1]
    user_supercell = [[1, supercell[0]], [1, supercell[1]], [1, supercell[2]]]
    return MolecularSystem.load_system(create_supercell(system=system, supercell=user_supercell))


def _size_buckets(maxds) -> list[tuple[list[int], float]]:
    """Positions grouped by their exact sampling sizes, each group with
    its largest maximum diameter (the pin that reproduces those sizes)."""
    buckets: dict = {}
    for i, m in enumerate(maxds):
        n_win, n_avg, _, _ = static_sizes(float(m), DEFAULT_CONFIG)
        idxs, ref = buckets.get((n_win, n_avg), ([], 0.0))
        idxs.append(i)
        buckets[(n_win, n_avg)] = (idxs, max(ref, float(m)))
    return list(buckets.values())


class Trajectory:
    """Base trajectory: byte-mapped frames and their analysis."""

    #: coordinate block (bytes of (F, N, 3) float64) above which a sweep
    #: takes the generic chunked path instead of one whole decode
    _SWEEP_DECODE_BUDGET = 2 * 1024**3

    def __init__(self, filepath: pathlib.Path | str, use_native: bool = True) -> None:
        self.filepath = pathlib.Path(filepath)
        self.filename = self.filepath.name
        self.system_id = self.filename.split(".")[0]
        #: decode (and rebuild) through the native library, else through
        #: the Python decoders and the numpy BFS
        self.use_native = use_native
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

    def _get_frame(self, frame_no: int, swap_atoms=None, forcefield=None) -> MolecularSystem:
        return self._system(self._raw_frames([frame_no])[0], frame_no, swap_atoms, forcefield)

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

    # -- whole-sweep decode ----------------------------------------------

    def _sweep_batch_fn(self):
        """The format's native whole-sweep decoder, ``fn(buf, starts,
        ends, n_atoms, ref_ids, **slabs) -> (coords, ids_match) | None``
        (``slabs``: see :func:`~pywindow_torch.native.decode_dlpoly_frames_batch`),
        or None where the format has none."""
        return None

    def _sweep_elements(self, ids_key, ids0, swap_atoms, forcefield) -> np.ndarray:
        """The element list of frames whose atom ids are ``ids0``: one
        representative frame takes the swap/decipher semantics for all."""
        rep = self._system(
            {ids_key: ids0.copy(), "coordinates": np.zeros((len(ids0), 3))}, "sweep",
            swap_atoms, forcefield,
        )
        return np.asarray(rep.system_to_molecule().elements)

    def _sweep_open_native(self, frames, swap_atoms, forcefield):
        """Open the streamed sweep's slab decoder over ``frames``:
        ``(elements, decode_slab, close)``, or None where the format has
        no native batch decoder, the trajectory was opened with
        ``use_native=False``, or the frames' coordinates exceed
        :attr:`_SWEEP_DECODE_BUDGET`.

        ``decode_slab(lo, hi, out64=None, out32=None)`` decodes frame
        positions [lo, hi) in one threaded native pass (the GIL
        released) straight into the sweep's slab and returns their
        maximum diameters, computed in the same pass; it raises
        :class:`SweepDecodeError` when a frame does not parse or its atom
        ids diverge from the first frame's.  ``close()`` releases the
        file map."""
        batch_fn = self._sweep_batch_fn() if self.use_native else None
        if batch_fn is None:
            return None
        raw0 = self._raw_frames([frames[0]])[0]
        ids_key = "atom_ids" if "atom_ids" in raw0 else "elements"
        ids0 = np.asarray(raw0[ids_key], dtype="<U8")
        n = len(ids0)
        if n == 0 or len(frames) * n * 24 > self._SWEEP_DECODE_BUDGET:
            return None
        elements = self._sweep_elements(ids_key, ids0, swap_atoms, forcefield)
        vdw = tables.ELEMENT_VDW[tables.element_ids(elements)].astype(np.float64)
        ref_ids = ids0.astype("S9").tobytes()
        starts = np.array([self.trajectory_map[f][0] for f in frames], dtype=np.int64)
        ends = np.array([self.trajectory_map[f][1] for f in frames], dtype=np.int64)
        native.lib()  # build before the buffer is exported
        fh = self.filepath.open()
        mapped = mmap(fh.fileno(), 0, access=ACCESS_READ)
        holder = {"buf": np.frombuffer(mapped, dtype=np.uint8)}

        def decode_slab(lo: int, hi: int, out64=None, out32=None) -> np.ndarray:
            maxd = np.empty(hi - lo, dtype=np.float64)
            got = batch_fn(
                holder["buf"], starts[lo:hi], ends[lo:hi], n, ref_ids,
                vdw=vdw, maxd=maxd, out64=out64, out32=out32,
            )
            if got is None:
                msg = f"a frame of positions {lo}..{hi - 1} does not parse"
                raise SweepDecodeError(msg)
            if not got[1]:
                msg = f"atom ids of positions {lo}..{hi - 1} diverge from the first frame's"
                raise SweepDecodeError(msg)
            return maxd

        def close() -> None:
            holder.clear()  # release the buffer before the map closes
            mapped.close()
            fh.close()

        return elements, decode_slab, close

    def _decode_uniform(self, todo, swap_atoms, forcefield):
        """Every frame decoded up front (``exact_sizes``, and
        ``use_native=False`` with the Python decoders):
        ``(elements, coordinates (F, N, 3) float64)`` of frames that
        all carry frame ``todo[0]``'s atom ids, or None when they do not
        (or a frame does not parse, or the block exceeds its budget):
        the caller then takes the generic path.  One representative
        frame takes the swap/decipher semantics for all."""
        raw0 = self._raw_frames([todo[0]])[0]
        ids_key = "atom_ids" if "atom_ids" in raw0 else "elements"
        ids0 = np.asarray(raw0[ids_key], dtype="<U8")
        n = len(ids0)
        if n == 0 or len(todo) * n * 24 > self._SWEEP_DECODE_BUDGET:
            return None
        batch_fn = self._sweep_batch_fn() if self.use_native else None
        if batch_fn is not None:
            native.lib()  # build before the buffer is exported
            starts = np.array([self.trajectory_map[f][0] for f in todo], dtype=np.int64)
            ends = np.array([self.trajectory_map[f][1] for f in todo], dtype=np.int64)
            with (
                self.filepath.open() as fh,
                closing(mmap(fh.fileno(), 0, access=ACCESS_READ)) as mapped,
            ):
                buf = np.frombuffer(mapped, dtype=np.uint8)
                try:
                    got = batch_fn(buf, starts, ends, n, ids0.astype("S9").tobytes())
                finally:
                    del buf  # release the buffer before the map closes
            if got is None or not got[1]:
                return None
            coords = got[0]
        else:
            raws = self._raw_frames(todo)
            if any(not np.array_equal(np.asarray(r[ids_key]), ids0) for r in raws):
                return None
            coords = np.stack([np.asarray(r["coordinates"], np.float64) for r in raws])
        return self._sweep_elements(ids_key, ids0, swap_atoms, forcefield), coords

    # -- analysis ---------------------------------------------------------

    def analysis(
        self,
        frames="all",
        ncpus: int = 1,
        ncpus_analysis: int = 1,
        override: bool = False,
        modular: bool = False,
        rebuild: bool = False,
        swap_atoms: dict | None = None,
        forcefield: str | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        """Analyse frames one molecule at a time on ``device`` (the card
        unless the caller asks for the CPU); results land in
        :attr:`analysis_output`.  Frames already analysed are skipped
        unless ``override`` (reference: trajectory.py:463-471).
        ``ncpus`` and ``ncpus_analysis`` are accepted for API
        compatibility and ignored."""
        del ncpus, ncpus_analysis
        todo = self._resolve_frames(frames)
        if not override:
            todo = [f for f in todo if f not in self.analysis_output]
        for frame in todo:
            molsys = self._get_frame(frame, swap_atoms, forcefield)
            if modular:
                molsys.make_modular(rebuild=rebuild, use_native=self.use_native)
                molecules = molsys.molecules
            else:
                molecules = {"0": molsys.system_to_molecule()}
            self.analysis_output[frame] = {
                key: mol.full_analysis(device=device) for key, mol in molecules.items()
            }

    @profiling.entry_point("analysis_batched", "sweep")
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
        autosave_every: int = 10,
        exact_sizes: bool = False,
        device: DeviceSpec | None = None,
    ) -> None:
        """Analyse frames as device batches on ``device`` (every local
        card unless the caller asks for others or the CPU; see
        :func:`~pywindow_torch.parallel.mesh.frame_devices`); results
        land in :attr:`analysis_output` with the schema of
        :meth:`analysis`.

        Frames already analysed are skipped unless ``override``, which
        replaces their entries whole.  ``batch_size``: frames per chunk
        (default: the largest memory-safe chunk on the uniform path, 256
        frames on the generic one).  One sampling pin serves a chunk: the
        largest maximum diameter in it (uniform path: in the sweep),
        unless ``reference_max_diameter`` is given; ``exact_sizes``
        instead buckets frames by their own sampling sizes, so the
        results equal :meth:`analysis`'s.  ``modular`` splits each frame
        into its molecules, ``rebuild`` first makes whole the molecules
        that cross the periodic boundary.  ``autosave``: a JSON path that
        :meth:`save_analysis` writes every ``autosave_every`` chunks and
        at the end; :meth:`load_analysis` and a rerun resume from it.
        """
        frame_devices(device)  # raises before any work when no card is there
        todo = self._resolve_frames(frames)
        if not override:
            todo = [f for f in todo if f not in self.analysis_output]
        else:
            for f in todo:
                self.analysis_output.pop(f, None)
        if not todo:
            return

        chunks_done = [0]
        # the streamed sweep keeps "final" false while a mid-stream size
        # escalation may still re-deliver its chunks; no checkpoint is
        # written meanwhile (the other routes never escalate)
        size_gate = {"final": True}

        def chunk_done() -> None:
            chunks_done[0] += 1
            if (
                autosave is not None
                and chunks_done[0] % max(autosave_every, 1) == 0
                and size_gate["final"]
            ):
                self.save_analysis(autosave, override=True)
            if chunks_done[0] % 20 == 0:
                gc.collect()

        # the cyclic GC is suspended during the sweep: analysis_output
        # grows by many small dicts per chunk and full collections made
        # a 10k-frame sweep 23x slower in the JAX package; the loop makes
        # no cycles, and a bounded collect runs every 20 chunks
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            swept = False
            if not modular and not exact_sizes:
                with stage("sweep_open"):
                    opened = self._sweep_open_native(todo, swap_atoms, forcefield)
                if opened is not None:
                    swept = self._analysis_batched_stream(
                        todo, *opened, batch_size, reference_max_diameter, size_gate,
                        chunk_done, device,
                    )
                    if not swept:  # a slab did not decode: every frame anew
                        for f in todo:
                            self.analysis_output.pop(f, None)
                        size_gate["final"] = True
            elif not modular:
                with stage("trajectory_decode"):
                    uniform = self._decode_uniform(todo, swap_atoms, forcefield)
                if uniform is not None:
                    self._sweep_uniform(
                        todo, *uniform, batch_size, reference_max_diameter, exact_sizes,
                        chunk_done, device,
                    )
                    swept = True
            if not swept:
                self._sweep_generic(
                    todo, batch_size or _GENERIC_BATCH, modular, rebuild, swap_atoms,
                    forcefield, reference_max_diameter, exact_sizes, chunk_done, device,
                )
        finally:
            if gc_was_enabled:
                gc.enable()
        if autosave is not None:
            self.save_analysis(autosave, override=True)

    def _sweep_on_batch(self, todo, n_atoms, chunk_done):
        """The chunk recorder of the streamed and uniform sweeps:
        ``on_batch(positions, results)`` files each result as frame
        ``todo[position]``'s entry ``"0"`` (a re-delivered position
        overwrites), then counts the chunk (``chunk_done``: the autosave
        and the bounded garbage collection)."""

        def on_batch(positions, results) -> None:
            out = self.analysis_output
            for pos, props in zip(positions.tolist(), results):
                props.pop("molecular_weight", None)
                props["no_of_atoms"] = n_atoms
                out.setdefault(todo[pos], {})["0"] = props
            chunk_done()

        return on_batch

    def _analysis_batched_stream(
        self, todo, elements, decode_slab, close, batch_size, reference_max_diameter,
        size_gate, chunk_done, device,
    ) -> bool:
        """The streamed sweep of ``todo`` (see
        :func:`~pywindow_torch.parallel.batch.sweep_stream`) over the
        opened slab decoder, which it closes; False when a slab did not
        decode (:class:`SweepDecodeError`), and the caller takes the
        generic path."""
        on_batch = self._sweep_on_batch(todo, len(elements), chunk_done)
        size_gate["final"] = False
        try:
            batch.sweep_stream(
                elements, len(todo), decode_slab, on_batch, batch_size=batch_size,
                reference_max_diameter=reference_max_diameter, size_gate=size_gate,
                device=device,
            )
        except SweepDecodeError:
            return False
        finally:
            close()
        return True

    def _sweep_uniform(
        self, todo, elements, coords, batch_size, reference_max_diameter, exact_sizes,
        chunk_done, device,
    ) -> None:
        """Frames decoded up front through :func:`batch.sweep_uniform`,
        one sweep per sampling-size bucket under ``exact_sizes``."""
        with stage("sweep_max_diameters"):
            maxd = batch.frame_max_diameters(elements, coords, device)
        if exact_sizes:
            groups = [(np.asarray(i), ref) for i, ref in _size_buckets(maxd)]
        else:
            groups = [(np.arange(len(todo)), reference_max_diameter)]
        record = self._sweep_on_batch(todo, len(elements), chunk_done)
        for idxs, ref in groups:
            whole = len(idxs) == len(todo)
            batch.sweep_uniform(
                elements, coords if whole else coords[idxs], maxd if whole else maxd[idxs],
                lambda positions, results, idxs=idxs: record(idxs[positions], results),
                batch_size=batch_size, reference_max_diameter=ref, device=device,
            )

    def _sweep_generic(
        self, todo, size, modular, rebuild, swap_atoms, forcefield, reference_max_diameter,
        exact_sizes, chunk_done, device,
    ) -> None:
        """Chunks of frames, each split into molecules (or taken whole),
        analysed as device batches (reference: trajectory.py:553-586)."""
        cache = None
        groups = [(todo, reference_max_diameter)]
        if exact_sizes:
            # pre-scan: every frame's exact maximum diameter; the decoded
            # frames are kept for the sweep up to a bound
            cache = {} if len(todo) <= _FRAME_CACHE_LIMIT else None
            maxds = []
            for f in todo:
                with stage("trajectory_decode"):
                    molsys = self._get_frame(f, swap_atoms, forcefield)
                if cache is not None:
                    cache[f] = molsys
                maxds.append(max_dim_host(molsys.system["elements"], molsys.system["coordinates"]))
            groups = [([todo[i] for i in idxs], ref) for idxs, ref in _size_buckets(maxds)]
        for frames_g, ref_g in groups:
            for lo in range(0, len(frames_g), size):
                chunk = frames_g[lo : lo + size]
                jobs, systems = self._prepare(chunk, modular, rebuild, swap_atoms, forcefield, cache)
                if systems:
                    results, pin = self._dispatch_all(systems, ref_g, device)
                    # saturated molecules re-run escalated, at the
                    # chunk's pin, before anything is recorded
                    with stage("sweep_retry"):
                        results = batch.retry_saturated_windows(
                            systems, results, DEFAULT_CONFIG, reference_max_diameter=pin,
                            device=device,
                        )
                    for (frame, key), (els, _), props in zip(jobs, systems, results):
                        props.pop("molecular_weight", None)
                        props["no_of_atoms"] = len(els)
                        self.analysis_output.setdefault(frame, {})[key] = props
                # frames that yield no molecules still count as analysed
                for frame in chunk:
                    self.analysis_output.setdefault(frame, {})
                chunk_done()

    def _prepare(self, chunk, modular, rebuild, swap_atoms, forcefield, cache):
        """(frame, molecule key) jobs and their (elements, coordinates)."""
        jobs, systems = [], []
        for frame in chunk:
            molsys = None if cache is None else cache.pop(frame, None)
            if molsys is None:
                with stage("trajectory_decode"):
                    molsys = self._get_frame(frame, swap_atoms, forcefield)
            if modular:
                with stage("trajectory_rebuild"):
                    molsys.make_modular(rebuild=rebuild, use_native=self.use_native)
                mols = molsys.molecules
            else:
                mols = {"0": molsys.system_to_molecule()}
            for key, mol in mols.items():
                jobs.append((frame, key))
                systems.append((mol.elements, mol.coordinates))
        return jobs, systems

    @staticmethod
    def _dispatch_all(systems, reference_max_diameter, device):
        """Results of ``systems`` (with the re-run markers still in) and
        the sampling pin they share.  Systems are bucketed by padded atom
        count, so a chunk of varying sizes is not padded to its largest
        member, and each bucket runs in memory-safe batches; one pin (the
        chunk's largest exact maximum diameter unless given) serves every
        bucket and batch, so no result depends on how the chunk splits."""
        pads = [round_up(max(len(e), 1), pad_multiple()) for e, _ in systems]
        bounds = [max_dim_bound(e, c) for e, c in systems]
        pin = reference_max_diameter
        if pin is None:
            pin = batch._largest_exact_maxd(systems, device)
        results: list = [None] * len(systems)
        for p in sorted(set(pads)):
            idxs = [i for i, q in enumerate(pads) if q == p]
            safe = batch.max_safe_batch(p, max(bounds[i] for i in idxs), device=device)
            for lo in range(0, len(idxs), safe):
                part = idxs[lo : lo + safe]
                handle = batch.dispatch_batch(
                    [systems[i] for i in part], reference_max_diameter=pin,
                    pad_atoms=p, device=device, span="sweep_step",
                )
                for i, r in zip(part, batch.collect_batch(handle)):
                    results[i] = r
        return results, pin

    # -- persistence -------------------------------------------------------

    def load_analysis(self, filepath: pathlib.Path | str) -> None:
        """Reload a :meth:`save_analysis` JSON to resume: the frames in it
        are then skipped by ``analysis*(override=False)``."""
        with pathlib.Path(filepath).open() as fh:
            data = json.load(fh)
        for frame_key, mols in data.items():
            try:
                frame: int | str = int(frame_key)
            except ValueError:
                frame = frame_key
            self.analysis_output[frame] = mols

    def save_analysis(
        self, filepath: pathlib.Path | str | None = None, override: bool = False
    ) -> None:
        """Write ``analysis_output`` as JSON (also the autosave format;
        reference: trajectory.py:745)."""
        if filepath is None:
            filepath = pathlib.Path.cwd() / f"{self.system_id}_pywindow_analysis"
        Output().dump2json(
            self.analysis_output, pathlib.Path(filepath), default=to_list, override=override
        )

    def save_frames(
        self,
        frames="all",
        filepath: pathlib.Path | str | None = None,
        decipher: bool = True,
        swap_atoms: dict | None = None,
        forcefield: str | None = None,
        **kwargs,
    ) -> None:
        """Write frames to ``<stem>_<frame>.pdb`` or ``.xyz`` files,
        swapping and deciphering force-field keys first when asked
        (reference: trajectory.py:669)."""
        if filepath is None:
            filepath = pathlib.Path.cwd() / str(self.system_id)
        filepath = pathlib.Path(filepath)
        if filepath.suffix not in (".pdb", ".xyz"):
            msg = (
                f"the {filepath.suffix} extension is not supported for "
                "dumping frames; use .pdb or .xyz"
            )
            raise ValueError(msg)
        for frame in self._resolve_frames(frames):
            molsys = self._get_frame(frame)
            if decipher and forcefield is not None:
                if swap_atoms is not None:
                    if not isinstance(swap_atoms, dict):
                        msg = "swap_atoms must be a dictionary"
                        raise TypeError(msg)
                    molsys.swap_atom_keys(swap_atoms)
                molsys.decipher_atom_keys(forcefield)
            if "elements" not in molsys.system:
                msg = (
                    "the frame needs an 'elements' key; set decipher=True "
                    "with a forcefield (see manual)"
                )
                raise ValueError(msg)
            Output().dump2file(
                molsys.system,
                filepath.with_name(f"{filepath.stem}_{frame}{filepath.suffix}"),
                atom_ids_key="elements" if "atom_ids" not in molsys.system else "atom_ids",
                **kwargs,
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

    def __init__(self, filepath: pathlib.Path | str, use_native: bool = True) -> None:
        super().__init__(filepath, use_native)
        with stage("trajectory_map"):
            if not (use_native and self._map_history_native()):
                self._check_history()
                self._map_history()

    def _map_history_native(self) -> bool:
        """The map and the integrity check in one native pass; False
        when the file has no timestep record (the Python pair then gives
        its exact behaviour)."""
        native.lib()  # build before the buffer is exported: a failed
        # build must not raise while the map still has an export
        got, err = None, None
        with (
            self.filepath.open() as fh,
            closing(mmap(fh.fileno(), 0, access=ACCESS_READ)) as mapped,
        ):
            buf = np.frombuffer(mapped, dtype=np.uint8)
            try:
                # a frame is at least ~1 KB for any real system; a file
                # of tiny frames retries with 8x the capacity
                cap = max(1024, buf.size // 1024)
                while True:
                    got = native.map_history(buf, cap)
                    if got is not None or cap > buf.size:
                        break
                    cap *= 8
            except ValueError as exc:
                kind, _, line = str(exc).partition(":")
                what = "the file contains an empty line" if kind == "empty" else (
                    "the trajectory is discontinuous"
                )
                err = f"Line {line}: {what}"
            finally:
                del buf  # release the buffer before the map closes
            if got is not None and len(got[0]):
                self._decode_header(mapped[0 : got[2]])
        if err is not None:
            raise TrajectoryError(err)
        if got is None or not len(got[0]):
            return False
        starts, ends, _, warn = got
        self.check_log = ""
        if warn & 1:
            self.check_log += "Line 1: no comment line present as the file header\n"
        if warn & 2:
            self.check_log += (
                "Line 2: second header line (periodicity / trajectory type) is missing\n"
            )
        s_l, e_l = starts.tolist(), ends.tolist()
        self.trajectory_map = {i: [s, e] for i, (s, e) in enumerate(zip(s_l, e_l))}
        self.no_of_frames = len(s_l)
        return True

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
        self._keytrj = keytrj
        self._imcon = imcon

    def _sweep_batch_fn(self):
        keytrj = getattr(self, "_keytrj", None)
        if keytrj not in (0, 1, 2) or self._imcon not in (0, 1, 2, 3):
            return None
        has_cell = self._imcon in (1, 2, 3)
        return lambda buf, s, e, n, rid, **slabs: native.decode_dlpoly_frames_batch(
            buf, s, e, keytrj, has_cell, n, rid, **slabs
        )

    def _decode_raw(self, raw: str) -> dict:
        """One HISTORY frame: the native parser (every keytrj), or the
        Python stride decode without it or where it does not parse."""
        head = raw[: raw.find("\n")].split()
        info = {
            "nstep": int(head[1]),
            "natms": int(head[2]),
            "keytrj": int(head[3]),
            "imcon": int(head[4]),
            "tstep": float(head[5]),
        }
        if self.use_native and info["keytrj"] in (0, 1, 2):
            got = native.decode_dlpoly_frame(
                raw.encode(), keytrj=info["keytrj"],
                has_cell=info["imcon"] in (1, 2, 3), n_atoms_hint=info["natms"],
            )
            if got is not None and len(got[0]) == info["natms"]:
                ids, coords, lattice, vel, frc = got
                out = {"frame_info": info, "atom_ids": ids, "coordinates": coords}
                if lattice is not None:
                    out["lattice"] = lattice
                    out["unit_cell"] = lattice_array_to_unit_cell(lattice)
                if vel is not None:
                    out["velocities"] = vel
                if frc is not None:
                    out["forces"] = frc
                return out
        return super()._decode_raw(raw)

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


class XYZ(Trajectory):
    """XYZ trajectory: frames open with an atom-count line (reference:
    trajectory.py:836-931).  Element symbols land in ``atom_ids``."""

    def __init__(self, filepath: pathlib.Path | str, use_native: bool = True) -> None:
        super().__init__(filepath, use_native)
        with stage("trajectory_map"):
            self._map_trajectory()

    def _map_trajectory(self) -> None:
        self.trajectory_map = {}
        with (
            self.filepath.open() as fh,
            closing(mmap(fh.fileno(), 0, access=ACCESS_READ)) as mapped,
        ):
            progress = 0
            frame = -1
            frame_start = 0
            while True:
                bline = mapped.readline()
                if len(bline) == 0:
                    frame += 1
                    self.trajectory_map[frame] = [frame_start, progress]
                    break
                sline = bline.decode("utf-8").strip("\n").split()
                if len(sline) == 1 and sline[0].lstrip("+-").isdigit() and progress > 0:
                    frame += 1
                    self.trajectory_map[frame] = [frame_start, progress]
                    frame_start = progress
                progress += len(bline)
        self.no_of_frames = frame + 1

    def _decode_raw(self, raw: str) -> dict:
        head, _, rest = raw.partition("\n")
        remark = rest.partition("\n")[0]
        natms = int(head.split()[0])
        if self.use_native:
            got = native.decode_xyz_frame(raw.encode(), n_atoms_hint=natms)
            if got is not None and len(got[0]) == natms:
                return {
                    "frame_info": {"natms": natms, "remarks": " ".join(remark.split())},
                    "atom_ids": got[0],
                    "coordinates": got[1],
                }
        return super()._decode_raw(raw)

    def _decode_frame(self, frame: list) -> dict:
        return {
            "frame_info": {"natms": int(frame[0][0]), "remarks": " ".join(frame[1])},
            "atom_ids": np.array([row[0] for row in frame[2:]]),
            "coordinates": np.array([row[1:4] for row in frame[2:]], dtype=float),
        }

    def _sweep_batch_fn(self):
        return native.decode_xyz_frames_batch


class PDB(Trajectory):
    """PDB trajectory, frames separated by END lines (reference:
    trajectory.py:934-1045).  Atom names land in ``atom_ids``; a CRYST1
    line becomes ``unit_cell`` and ``lattice``."""

    def __init__(self, filepath: pathlib.Path | str, use_native: bool = True) -> None:
        super().__init__(filepath, use_native)
        with stage("trajectory_map"):
            self._map_trajectory()

    def _map_trajectory(self) -> None:
        self.trajectory_map = {}
        with (
            self.filepath.open() as fh,
            closing(mmap(fh.fileno(), 0, access=ACCESS_READ)) as mapped,
        ):
            progress = 0
            frame = -1
            frame_start = 0
            while True:
                bline = mapped.readline()
                if len(bline) == 0:
                    if progress - frame_start > 10:
                        frame += 1
                        self.trajectory_map[frame] = [frame_start, progress]
                    break
                sline = bline.decode("utf-8").strip("\n").split()
                if len(sline) == 1 and sline[0] == "END":
                    frame += 1
                    self.trajectory_map[frame] = [frame_start, progress]
                    frame_start = progress
                progress += len(bline)
        self.no_of_frames = frame + 1

    def _decode_raw(self, raw: str) -> dict:
        """Fixed-column decode: native unless the frame has REMARK lines
        (rare in MD frames; the Python decoder keeps them)."""
        if self.use_native and "REMARK" not in raw:
            got = native.decode_pdb_frame(raw.encode(), n_atoms_hint=raw.count("\n") + 1)
            if got is not None:
                ids, coords, cryst = got
                out: dict = {"atom_ids": ids, "coordinates": coords}
                if cryst is not None:
                    out["CRYST1"] = cryst
                    out["unit_cell"] = cryst
                    out["lattice"] = unit_cell_to_lattice_array(cryst)
                return out
        return self._decode_frame(raw.split("\n"))

    def _decode_frame(self, lines: list[str]) -> dict:
        out: dict = {}
        elements = []
        coordinates = []
        for ln in lines:
            if ln[:6] == "REMARK":
                out.setdefault("REMARKS", []).append(ln[6:])
            elif ln[:6] == "CRYST1":
                cryst = np.array(
                    [ln[6:15], ln[15:24], ln[24:33], ln[33:40], ln[40:47], ln[47:54]],
                    dtype=float,
                )
                if cryst[0:3].sum() != 0:
                    out["CRYST1"] = cryst
                    # the reference left CRYST1 unconverted, so periodic
                    # PDB trajectories could not rebuild
                    # (trajectory.py:1022-1037)
                    out["unit_cell"] = cryst
                    out["lattice"] = unit_cell_to_lattice_array(cryst)
            elif ln[:6] in ("HETATM", "ATOM  "):
                elements.append(ln[12:16].strip())
                coordinates.append([ln[30:38], ln[38:46], ln[46:54]])
        out["atom_ids"] = np.array(elements, dtype="<U8")
        out["coordinates"] = np.array(coordinates, dtype=float)
        return out

    def _sweep_batch_fn(self):
        return native.decode_pdb_frames_batch
