"""ctypes bindings of the native host library (counterpart of
``pywindow_tpu.native``).

``_native/rebuild_core.cpp`` holds the host loops that feed the device
pipeline: the exact-parity BFS of the periodic rebuild over a bin index
of its coordinates (:class:`BinIndex`), the one-pass
DL_POLY HISTORY map with its integrity check, and the DL_POLY, XYZ and
PDB frame decoders (one frame, or a whole sweep on several threads).

The library is built at first use with ``g++`` into
``<checkout>/build/pywindow_torch/native/`` (listed in ``.gitignore``),
named by a hash of its source and flags, through a temporary file and an
atomic rename, so concurrent processes never load a half-written file.
``-ffp-contract=off`` keeps the BFS's distance tests bitwise equal to
numpy's.  A failed build or load raises with the compiler's output:
nothing falls back to the numpy BFS or the Python decoders on its own.
Those stay as the plain versions, which a caller asks for explicitly
(``use_native=False``).  The wrappers return None only where the data
decides it: a frame that does not parse, or a map that outgrows its
capacity.

:data:`CALLS` counts the library calls by function, so a run can show
that it went through the native code.

:func:`fastprops` builds and imports the second native module,
``_native/fastprops.cpp``: a CPython extension that turns a packed
result block into the reference's properties dicts (it needs the Python
and numpy headers, so it is a module of its own, built the same way and
raising the same error when it cannot be built).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
import weakref

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "_native" / "rebuild_core.cpp"
BUILD_DIR = (
    pathlib.Path(__file__).resolve().parent.parent / "build" / "pywindow_torch" / "native"
)
#: the compiler and its flags (those of the JAX package's build)
CXX = "g++"
CXX_FLAGS = (
    "-O3", "-shared", "-fPIC", "-std=c++17",
    "-ffp-contract=off", "-fno-fast-math", "-pthread",
)

#: native library calls by function (see the module docstring)
CALLS: collections.Counter = collections.Counter()


class NativeBuildError(RuntimeError):
    """The native library failed to build or to load."""


def _build(so: pathlib.Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix="pywindow_native_", dir=so.parent)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        pathlib.Path(tmp).unlink(missing_ok=True)
        msg = f"pywindow_torch.native: {' '.join(cmd)} failed: {exc}"
        raise NativeBuildError(msg) from exc
    if proc.returncode != 0:
        pathlib.Path(tmp).unlink(missing_ok=True)
        msg = (
            f"pywindow_torch.native: {' '.join(cmd)} exited with "
            f"{proc.returncode}:\n{proc.stdout}{proc.stderr}"
        )
        raise NativeBuildError(msg)
    os.replace(tmp, so)


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed (once per
    process); raises :class:`NativeBuildError` when it cannot be."""
    key = hashlib.sha1(
        SOURCE.read_bytes() + " ".join((CXX, *CXX_FLAGS)).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"libpywindow_native-{key}.so"
    if not so.is_file():
        _build(so)
    try:
        L = ctypes.CDLL(str(so))
    except OSError as exc:
        msg = f"pywindow_torch.native: cannot load {so}: {exc}"
        raise NativeBuildError(msg) from exc

    c_d = ctypes.POINTER(ctypes.c_double)
    c_u8 = ctypes.POINTER(ctypes.c_uint8)
    c_i64 = ctypes.POINTER(ctypes.c_int64)
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    c_f = ctypes.POINTER(ctypes.c_float)
    c_vp = ctypes.c_void_p
    c_l = ctypes.c_long
    L.pw_bin_index_new.restype = c_vp
    L.pw_bin_index_new.argtypes = [
        c_l, c_d, c_l, c_d, ctypes.c_double, ctypes.POINTER(c_l), c_d,
    ]
    L.pw_bin_index_free.restype = None
    L.pw_bin_index_free.argtypes = [c_vp]
    L.pw_bfs_molecule.restype = c_l
    L.pw_bfs_molecule.argtypes = [
        c_vp, c_l, c_d, c_d, c_u8, c_i64, c_l, c_d, c_d, c_u8, c_i64, c_i64,
        ctypes.c_double, ctypes.c_double, c_l, c_u8, c_i32, c_i64, c_l, c_i64,
    ]
    L.pw_decode_dlpoly_frame.restype = c_l
    L.pw_decode_dlpoly_frame.argtypes = [
        ctypes.c_char_p, c_l, c_l, c_l, c_d, ctypes.c_char_p, c_d, c_d, c_d, c_l,
    ]
    L.pw_decode_xyz_frame.restype = c_l
    L.pw_decode_xyz_frame.argtypes = [ctypes.c_char_p, c_l, ctypes.c_char_p, c_d, c_l]
    L.pw_decode_pdb_frame.restype = c_l
    L.pw_decode_pdb_frame.argtypes = [
        ctypes.c_char_p, c_l, ctypes.c_char_p, c_d, c_d, ctypes.POINTER(c_l), c_l,
    ]
    L.pw_map_history.restype = c_l
    L.pw_map_history.argtypes = [c_vp, c_l, c_i64, c_i64, c_l, c_i64, c_i64, c_i64]
    L.pw_decode_dlpoly_frames_batch.restype = c_l
    L.pw_decode_dlpoly_frames_batch.argtypes = [
        c_vp, c_i64, c_i64, c_l, c_l, c_l, c_l, ctypes.c_char_p, c_d, c_f, c_d, c_d, c_l, c_i64,
    ]
    for name in ("pw_decode_xyz_frames_batch", "pw_decode_pdb_frames_batch"):
        fn = getattr(L, name)
        fn.restype = c_l
        fn.argtypes = [
            c_vp, c_i64, c_i64, c_l, c_l, ctypes.c_char_p, c_d, c_f, c_d, c_d, c_l, c_i64,
        ]
    return L


def _ptr(arr: np.ndarray | None, ctype):
    if arr is None:
        return ctypes.cast(None, ctypes.POINTER(ctype))
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _ids(buf, count: int) -> np.ndarray:
    """Atom ids from the library's 9-byte records."""
    return np.frombuffer(buf.raw, dtype="S9", count=count).astype("<U8")


class BinIndex:
    """The native bin index of one rebuild's coordinates: the unit cell's
    ``coords`` and the supercell's ``scoords`` (or none) in two grids of
    one geometry, bins of edge ``edge`` >= ``max_dist`` * (1 + 1e-4),
    ``dims`` bins per axis (at most 2**20 in all: a far stray atom
    enlarges the edge).  Built once and shared by the rebuild's
    :func:`bfs_molecule` calls; the library's memory is freed with the
    object."""

    def __init__(self, coords: np.ndarray, scoords: np.ndarray | None, max_dist: float) -> None:
        coords = _f64(coords).reshape(-1, 3)
        scoords = np.zeros((0, 3)) if scoords is None else _f64(scoords).reshape(-1, 3)
        dims = (ctypes.c_long * 3)()
        edge = ctypes.c_double()
        handle = lib().pw_bin_index_new(
            len(coords), _ptr(coords, ctypes.c_double), len(scoords),
            _ptr(scoords, ctypes.c_double), float(max_dist), dims, ctypes.byref(edge),
        )
        CALLS["bin_index"] += 1
        if not handle:
            msg = f"bin_index: out of memory for {len(coords)} + {len(scoords)} atoms"
            raise MemoryError(msg)
        self.handle = handle
        self.sizes = (len(coords), len(scoords))
        self.dims = tuple(dims)
        self.edge = edge.value
        weakref.finalize(self, lib().pw_bin_index_free, handle)


def bfs_molecule(
    seed: int,
    unassigned: np.ndarray,
    coords: np.ndarray,
    cov: np.ndarray,
    heavy: np.ndarray,
    key_id: np.ndarray,
    scoords: np.ndarray | None,
    scov: np.ndarray | None,
    sheavy: np.ndarray | None,
    skey_id: np.ndarray | None,
    s_match_unit: np.ndarray | None,
    max_dist: float,
    tol: float,
    *,
    index: BinIndex,
) -> tuple[np.ndarray, np.ndarray, int]:
    """One molecule's BFS from ``seed``: (source (0 unit cell, 1
    supercell), index) of its atoms in discovery order, and the number
    of distance tests it made.  ``unassigned`` (uint8, C-contiguous) is
    updated in place.  ``index`` is the :class:`BinIndex` of ``coords``
    and ``scoords`` under this ``max_dist``: each expanded heavy atom
    tests the atoms of its 27 bins alone."""
    if unassigned.dtype != np.uint8 or not unassigned.flags["C_CONTIGUOUS"]:
        msg = "unassigned must be a C-contiguous uint8 array (updated in place)"
        raise TypeError(msg)
    n = len(coords)
    ns = 0 if scoords is None else len(scoords)
    if index.sizes != (n, ns):
        msg = f"bfs_molecule: the index holds {index.sizes} atoms, not {(n, ns)}"
        raise ValueError(msg)
    if ns == 0:
        scoords, scov = np.zeros((0, 3)), np.zeros(0)
        sheavy = np.zeros(0, dtype=np.uint8)
        skey_id = s_match_unit = np.zeros(0, dtype=np.int64)
    cap = n + ns
    out_src = np.empty(cap, dtype=np.int32)
    out_idx = np.empty(cap, dtype=np.int64)
    pairs = np.zeros(1, dtype=np.int64)
    got = lib().pw_bfs_molecule(
        index.handle,
        n, _ptr(_f64(coords), ctypes.c_double), _ptr(_f64(cov), ctypes.c_double),
        _ptr(np.ascontiguousarray(heavy, dtype=np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(key_id, dtype=np.int64), ctypes.c_int64),
        ns, _ptr(_f64(scoords), ctypes.c_double), _ptr(_f64(scov), ctypes.c_double),
        _ptr(np.ascontiguousarray(sheavy, dtype=np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(skey_id, dtype=np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(s_match_unit, dtype=np.int64), ctypes.c_int64),
        float(max_dist), float(tol), int(seed),
        _ptr(unassigned, ctypes.c_uint8), _ptr(out_src, ctypes.c_int32),
        _ptr(out_idx, ctypes.c_int64), cap, _ptr(pairs, ctypes.c_int64),
    )
    CALLS["bfs_molecule"] += 1
    if got < 0:
        msg = f"bfs_molecule: output capacity {cap} exceeded"
        raise RuntimeError(msg)
    return out_src[:got], out_idx[:got], int(pairs[0])


def decode_dlpoly_frame(raw: bytes, keytrj: int, has_cell: bool, n_atoms_hint: int):
    """One HISTORY frame's text -> (atom_ids '<U8', coordinates (N, 3),
    lattice (3, 3) or None, velocities or None, forces or None), the
    reference's stride semantics (velocities for keytrj >= 1, forces for
    keytrj == 2); None when the frame does not parse."""
    cap = max(n_atoms_hint, 1)
    ids = ctypes.create_string_buffer(cap * 9)
    xyz = np.empty((cap, 3), dtype=np.float64)
    cell = np.zeros((3, 3), dtype=np.float64)
    vel = np.empty((cap, 3), dtype=np.float64) if keytrj >= 1 else None
    frc = np.empty((cap, 3), dtype=np.float64) if keytrj >= 2 else None
    got = lib().pw_decode_dlpoly_frame(
        raw, len(raw), int(keytrj), int(bool(has_cell)), _ptr(cell, ctypes.c_double),
        ids, _ptr(xyz, ctypes.c_double), _ptr(vel, ctypes.c_double),
        _ptr(frc, ctypes.c_double), cap,
    )
    CALLS["decode_dlpoly_frame"] += 1
    if got < 0:
        return None
    return (
        _ids(ids, got),
        xyz[:got].copy(),
        cell.T if has_cell else None,
        None if vel is None else vel[:got].copy(),
        None if frc is None else frc[:got].copy(),
    )


def decode_xyz_frame(raw: bytes, n_atoms_hint: int):
    """One XYZ trajectory frame's atom lines -> (atom_ids '<U8',
    coordinates (N, 3)); the count and remark lines are the caller's.
    None when the frame does not parse."""
    cap = max(n_atoms_hint, 1)
    ids = ctypes.create_string_buffer(cap * 9)
    xyz = np.empty((cap, 3), dtype=np.float64)
    got = lib().pw_decode_xyz_frame(raw, len(raw), ids, _ptr(xyz, ctypes.c_double), cap)
    CALLS["decode_xyz_frame"] += 1
    if got < 0:
        return None
    return _ids(ids, got), xyz[:got].copy()


def decode_pdb_frame(raw: bytes, n_atoms_hint: int):
    """One PDB trajectory frame -> (atom_ids '<U8' from the atom-name
    columns, coordinates (N, 3), CRYST1 (6,) or None); None when the
    frame does not parse."""
    cap = max(n_atoms_hint, 1)
    ids = ctypes.create_string_buffer(cap * 9)
    xyz = np.empty((cap, 3), dtype=np.float64)
    cryst = np.zeros(6, dtype=np.float64)
    has_cryst = ctypes.c_long(0)
    got = lib().pw_decode_pdb_frame(
        raw, len(raw), ids, _ptr(xyz, ctypes.c_double), _ptr(cryst, ctypes.c_double),
        ctypes.byref(has_cryst), cap,
    )
    CALLS["decode_pdb_frame"] += 1
    if got < 0:
        return None
    return _ids(ids, got), xyz[:got].copy(), cryst if has_cryst.value else None


def map_history(buf: np.ndarray, cap_frames: int):
    """One-pass HISTORY map and integrity check of the file bytes ``buf``
    (a uint8 view) -> (starts, ends, header_end, warn_flags), or None
    when more than ``cap_frames`` frames are found.  Raises ValueError
    ``"empty:<line>"`` or ``"discontinuous:<line>"`` for the reference's
    integrity errors (reference: trajectory.py:768-833)."""
    cap = max(cap_frames, 1)
    starts = np.empty(cap, dtype=np.int64)
    ends = np.empty(cap, dtype=np.int64)
    header_end, warn_flags, err_line = (np.zeros(1, dtype=np.int64) for _ in range(3))
    got = lib().pw_map_history(
        buf.ctypes.data_as(ctypes.c_void_p), len(buf), _ptr(starts, ctypes.c_int64),
        _ptr(ends, ctypes.c_int64), cap, _ptr(header_end, ctypes.c_int64),
        _ptr(warn_flags, ctypes.c_int64), _ptr(err_line, ctypes.c_int64),
    )
    CALLS["map_history"] += 1
    if got == -1:
        msg = f"empty:{int(err_line[0])}"
        raise ValueError(msg)
    if got == -2:
        msg = f"discontinuous:{int(err_line[0])}"
        raise ValueError(msg)
    if got < 0:
        return None
    return starts[:got].copy(), ends[:got].copy(), int(header_end[0]), int(warn_flags[0])


def _decode_frames_batch(
    name, buf, starts, ends, n_atoms, ref_ids, extra=(), *,
    vdw=None, maxd=None, out64=None, out32=None,
):
    n_threads = min(8, os.cpu_count() or 1)
    f = len(starts)
    for out, dtype in ((out64, np.float64), (out32, np.float32), (maxd, np.float64)):
        if out is not None and (out.dtype != dtype or not out.flags["C_CONTIGUOUS"]):
            msg = f"{name}: output slabs must be C-contiguous {dtype.__name__} arrays"
            raise TypeError(msg)
    if any(o is not None and o.shape != (f, n_atoms, 3) for o in (out64, out32)):
        msg = f"{name}: output slabs must have shape ({f}, {n_atoms}, 3)"
        raise ValueError(msg)
    if (vdw is None) != (maxd is None):
        msg = f"{name}: vdw and maxd go together"
        raise ValueError(msg)
    # with only the float32 slab asked for, the library parses each frame
    # into a one-frame scratch and writes the float32 copy alone
    xyz = out64 if out64 is not None or out32 is not None else np.empty(
        (f, n_atoms, 3), dtype=np.float64
    )
    ids_match = np.zeros(1, dtype=np.int64)
    got = getattr(lib(), name)(
        buf.ctypes.data_as(ctypes.c_void_p),
        _ptr(np.ascontiguousarray(starts, dtype=np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(ends, dtype=np.int64), ctypes.c_int64),
        f, *extra, n_atoms, ref_ids, _ptr(xyz, ctypes.c_double),
        _ptr(out32, ctypes.c_float),
        _ptr(None if vdw is None else _f64(vdw), ctypes.c_double),
        _ptr(maxd, ctypes.c_double), n_threads, _ptr(ids_match, ctypes.c_int64),
    )
    CALLS[name.removeprefix("pw_")] += 1
    if got < 0:
        return None
    return xyz, bool(ids_match[0])


def decode_dlpoly_frames_batch(
    buf, starts, ends, keytrj: int, has_cell: bool, n_atoms: int, ref_ids: bytes, **slabs
):
    """Whole-sweep HISTORY decode on up to 8 threads (the ctypes call
    releases the GIL) -> (coordinates (F, N, 3) float64, ids_match),
    or None when a frame does not parse.  ``ref_ids`` is frame 0's id
    block (``ids.astype('S9').tobytes()``); ``ids_match`` says whether
    every frame's ids equal it, which a shared element list needs.

    The keyword outputs let one pass fill a sweep's own slabs (the
    streamed sweep's decoder thread): ``out64`` / ``out32`` (F, N, 3)
    float64 / float32 slabs to write the coordinates into (the float64
    one is returned; with ``out32`` alone None is), and ``maxd`` (F,)
    float64 filled with each frame's vdW-corrected maximum diameter
    under the per-atom radii ``vdw`` (N,), bit for bit
    :func:`pywindow_torch.ops.analysis.max_dim_host`."""
    return _decode_frames_batch(
        "pw_decode_dlpoly_frames_batch", buf, starts, ends, n_atoms, ref_ids,
        extra=(int(keytrj), int(bool(has_cell))), **slabs,
    )


def decode_xyz_frames_batch(buf, starts, ends, n_atoms, ref_ids, **slabs):
    """Whole-sweep XYZ trajectory decode; see :func:`decode_dlpoly_frames_batch`."""
    return _decode_frames_batch(
        "pw_decode_xyz_frames_batch", buf, starts, ends, n_atoms, ref_ids, **slabs
    )


def decode_pdb_frames_batch(buf, starts, ends, n_atoms, ref_ids, **slabs):
    """Whole-sweep PDB trajectory decode (CRYST1 cells are not returned);
    see :func:`decode_dlpoly_frames_batch`."""
    return _decode_frames_batch(
        "pw_decode_pdb_frames_batch", buf, starts, ends, n_atoms, ref_ids, **slabs
    )


# -- the native property-dict converter ------------------------------------

FASTPROPS_SOURCE = SOURCE.parent / "fastprops.cpp"


def _fastprops_cmd(out: str) -> list[str]:
    import sysconfig

    return [
        CXX, "-O3", "-shared", "-fPIC", "-std=c++17",
        "-I", sysconfig.get_paths()["include"], "-I", np.get_include(),
        "-o", out, str(FASTPROPS_SOURCE),
    ]


@functools.cache
def fastprops():
    """The ``_pw_fastprops`` CPython extension (``_native/fastprops.cpp``,
    the bulk converter of packed results into properties dicts), built
    at first use with ``g++`` against this interpreter's and numpy's
    headers into :data:`BUILD_DIR`, named by a hash of its source and
    command, as :func:`lib` is; raises :class:`NativeBuildError` when it
    cannot be built or loaded (no numpy fallback)."""
    import importlib.util
    import sysconfig

    key = hashlib.sha1(
        FASTPROPS_SOURCE.read_bytes()
        + " ".join(_fastprops_cmd("")).encode()
        + sysconfig.get_config_var("EXT_SUFFIX").encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"_pw_fastprops-{key}.so"
    if not so.is_file():
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", prefix="pw_fastprops_", dir=so.parent)
        os.close(fd)
        cmd = _fastprops_cmd(tmp)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            pathlib.Path(tmp).unlink(missing_ok=True)
            msg = f"pywindow_torch.native: {' '.join(cmd)} failed: {exc}"
            raise NativeBuildError(msg) from exc
        if proc.returncode != 0:
            pathlib.Path(tmp).unlink(missing_ok=True)
            msg = (
                f"pywindow_torch.native: {' '.join(cmd)} exited with "
                f"{proc.returncode}:\n{proc.stdout}{proc.stderr}"
            )
            raise NativeBuildError(msg)
        os.replace(tmp, so)
    try:
        spec = importlib.util.spec_from_file_location("_pw_fastprops", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except (ImportError, OSError) as exc:
        msg = f"pywindow_torch.native: cannot load {so}: {exc}"
        raise NativeBuildError(msg) from exc
    return mod


def props_dicts(flat: np.ndarray, max_windows: int):
    """The converter on a packed (B, packed_size(W)) float32 or float64
    block -> (dicts, rows whose refinement failed, rows with a negative
    window diameter); see :func:`pywindow_torch.ops.analysis.to_properties_dicts_bulk`."""
    from pywindow_torch.ops.analysis import packed_size

    if flat.ndim != 2 or flat.shape[1] != packed_size(max_windows):
        msg = f"props_dicts: a {flat.shape} block is not packed rows of {max_windows} window slots"
        raise ValueError(msg)
    got = fastprops().props_dicts(np.ascontiguousarray(flat), int(max_windows))
    CALLS["props_dicts"] += 1
    return got
