"""The native host library of pywindow_torch: its decoders against the
Python decoders (their plain versions) and against pywindow_tpu's
native decoders on the same bytes, its HISTORY map against the Python
map and pywindow_tpu's, its BFS against the numpy BFS, the BFS's
distance-test counter, and a failed build that raises.  Everything here is exact: the same text parses to
the same doubles and the same ids."""

import numpy as np
import pytest

import pywindow_torch as pt
import pywindow_tpu as pw
from pywindow_torch import native, profiling
from pywindow_torch.ops.cell import create_supercell
from pywindow_torch.ops.rebuild import discrete_molecules
from pywindow_torch.profiling import METRICS
from pywindow_tpu import native as jnative
from tests.conftest import DATA, load_xyz

HISTORY = DATA / "HISTORY_singlemol_short"


def _frame_bytes(traj, frame):
    start, end = traj.trajectory_map[frame]
    return traj.filepath.read_bytes()[start:end]


def _assert_frames_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in b:
        if isinstance(b[key], dict):
            assert a[key] == b[key]
        else:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


def _xyz_trajectory(path, n_frames=3):
    elements, coords = load_xyz(DATA / "PUDXES.xyz")
    rng = np.random.default_rng(5)
    blocks = []
    for k in range(n_frames):
        xyz = coords + rng.normal(scale=0.05, size=coords.shape)
        lines = [str(len(elements)), f"frame {k} remark  text"]
        lines += [f"{el} {x:.6f} {y:.6f} {z:.6f}" for el, (x, y, z) in zip(elements, xyz)]
        blocks.append("\n".join(lines))
    path.write_text("\n".join(blocks) + "\n")
    return path


def _pdb_trajectory(path, n_frames=2):
    text = (DATA / "system_periodic.pdb").read_text()
    body = [ln for ln in text[: text.rindex("END")].splitlines() if not ln.startswith("REMARK")]
    path.write_text(("\n".join(body) + "\nEND\n") * n_frames)
    return path


@pytest.mark.parametrize("frame", [0, 7, 19])
def test_dlpoly_decoders_match(frame):
    traj = pt.DLPOLY(HISTORY)
    raw = _frame_bytes(traj, frame).decode("utf-8")
    calls = native.CALLS["decode_dlpoly_frame"]
    fast = traj._decode_raw(raw)
    assert native.CALLS["decode_dlpoly_frame"] == calls + 1
    slow = pt.DLPOLY(HISTORY, use_native=False)._decode_raw(raw)
    jax = pw.DLPOLY(HISTORY)._decode_raw(raw)
    _assert_frames_equal(fast, slow)
    _assert_frames_equal(fast, jax)


def test_xyz_decoders_match(tmp_path):
    path = _xyz_trajectory(tmp_path / "t.xyz")
    traj, plain, jtraj = pt.XYZ(path), pt.XYZ(path, use_native=False), pw.XYZ(path)
    assert traj.trajectory_map == plain.trajectory_map == jtraj.trajectory_map
    for f in range(traj.no_of_frames):
        raw = _frame_bytes(traj, f).decode("utf-8")
        fast = traj._decode_raw(raw)
        _assert_frames_equal(fast, plain._decode_raw(raw))
        _assert_frames_equal(fast, jtraj._decode_raw(raw))


def test_pdb_decoders_match(tmp_path):
    # a frame with REMARK lines takes the Python decoder in both packages
    periodic = pt.PDB(DATA / "system_periodic.pdb")
    raw = _frame_bytes(periodic, 0).decode("utf-8")
    _assert_frames_equal(periodic._decode_raw(raw), pw.PDB(DATA / "system_periodic.pdb")._decode_raw_pdb(raw))
    path = _pdb_trajectory(tmp_path / "t.pdb")
    traj, plain, jtraj = pt.PDB(path), pt.PDB(path, use_native=False), pw.PDB(path)
    raw = _frame_bytes(traj, 1).decode("utf-8")
    calls = native.CALLS["decode_pdb_frame"]
    fast = traj._decode_raw(raw)
    assert native.CALLS["decode_pdb_frame"] == calls + 1
    assert "lattice" in fast
    _assert_frames_equal(fast, plain._decode_raw(raw))
    _assert_frames_equal(fast, jtraj._decode_raw_pdb(raw))


@pytest.mark.parametrize("fmt", ["dlpoly", "xyz", "pdb"])
def test_batch_decoders_match_single_frames(fmt, tmp_path):
    """The threaded whole-sweep decode equals the frames decoded one by
    one and the JAX package's batch decode, and flags varying ids."""
    if fmt == "dlpoly":
        path, cls, jcls = HISTORY, pt.DLPOLY, pw.DLPOLY
    elif fmt == "xyz":
        path, cls, jcls = _xyz_trajectory(tmp_path / "t.xyz"), pt.XYZ, pw.XYZ
    else:
        path, cls, jcls = _pdb_trajectory(tmp_path / "t.pdb", 3), pt.PDB, pw.PDB
    traj, jtraj = cls(path), jcls(path)
    frames = list(range(traj.no_of_frames))
    raws = traj._raw_frames(frames)
    ids0 = np.asarray(raws[0]["atom_ids"], dtype="<U8")
    buf = np.fromfile(path, dtype=np.uint8)
    starts = np.array([traj.trajectory_map[f][0] for f in frames], dtype=np.int64)
    ends = np.array([traj.trajectory_map[f][1] for f in frames], dtype=np.int64)
    fn, jfn = traj._sweep_batch_fn(), jtraj._sweep_batch_fn()
    ref_ids = ids0.astype("S9").tobytes()
    coords, ids_match = fn(buf, starts, ends, len(ids0), ref_ids)
    jcoords, jmatch, _ = jfn(buf, starts, ends, len(ids0), ref_ids, None)
    assert ids_match and jmatch
    np.testing.assert_array_equal(coords, np.stack([r["coordinates"] for r in raws]))
    np.testing.assert_array_equal(coords, jcoords)
    other = ids0.copy()
    other[-1] = "Zz"
    _, ids_match = fn(buf, starts, ends, len(ids0), other.astype("S9").tobytes())
    assert not ids_match
    ff = ({"he": "H"}, "OPLS") if fmt == "dlpoly" else (None, "DLF" if fmt == "pdb" else "OPLS")
    uniform = traj._decode_uniform(frames, *ff)
    plain = cls(path, use_native=False)._decode_uniform(frames, *ff)
    np.testing.assert_array_equal(uniform[1], plain[1])
    np.testing.assert_array_equal(uniform[0], plain[0])


def test_map_history_matches_python_and_jax():
    calls = native.CALLS["map_history"]
    fast = pt.DLPOLY(HISTORY)
    assert native.CALLS["map_history"] == calls + 1
    plain = pt.DLPOLY(HISTORY, use_native=False)
    ref = pw.DLPOLY(HISTORY)
    assert fast.trajectory_map == plain.trajectory_map == ref.trajectory_map
    assert fast.no_of_frames == plain.no_of_frames == 20
    assert fast.check_log == plain.check_log == ref.check_log
    for attr in ("no_of_atoms", "periodic_boundary", "content_type"):
        assert getattr(fast, attr) == getattr(plain, attr) == getattr(ref, attr)


def test_native_float_parse_fuzz(tmp_path):
    """The decoder's float parse is bitwise equal to Python's on long
    mantissas, large exponents, bare integers and trailing dots (the
    inputs of tests/test_native.py)."""
    rng = np.random.default_rng(20260817)
    nasty = [
        "0.0", "-0.0", "1", "-1.", "+2.5", "0.00001234", "9007199254740993.0",
        "1.23456789012345678901e10", "6.02e23", "-1.5e-25", "12345678901234567890",
        "3.0000000000000004", "1e0", "1E+00", "-7.25E-03",
    ]
    vals = [f"{rng.uniform(-1e4, 1e4):.4E}" for _ in range(60)]
    vals += [f"{rng.uniform(-1, 1):.17f}" for _ in range(30)]
    vals += nasty
    n = len(vals) // 3
    vals = vals[: n * 3]
    lines = [f"{n}", "remark"] + [f"C {vals[3 * a]} {vals[3 * a + 1]} {vals[3 * a + 2]}" for a in range(n)]
    path = tmp_path / "fuzz.xyz"
    path.write_text("\n".join(lines) + "\n")
    traj = pt.XYZ(path)
    got = native.decode_xyz_frame(_frame_bytes(traj, 0), n_atoms_hint=n)
    expected = np.array([float(v) for v in vals], dtype=np.float64).reshape(n, 3)
    np.testing.assert_array_equal(got[1], expected)
    np.testing.assert_array_equal(got[1], jnative.decode_xyz_frame(_frame_bytes(traj, 0), n)[1])


@pytest.mark.parametrize("rebuild", [False, True])
def test_native_bfs_matches_numpy(rebuild):
    system = pt.Input().load_file(DATA / "system_periodic.pdb")
    sc = create_supercell(system) if rebuild else None
    calls = native.CALLS["bfs_molecule"]
    a = discrete_molecules(system, rebuild=sc, use_native=True)
    assert native.CALLS["bfs_molecule"] > calls
    b = discrete_molecules(system, rebuild=sc, use_native=False)
    assert len(a) == len(b) == (8 if rebuild else 33)
    for ma, mb in zip(a, b):
        for key in ("elements", "coordinates", "atom_ids"):
            np.testing.assert_array_equal(ma[key], mb[key])


def test_bfs_pairs_counter(monkeypatch):
    """With profiling on, the rebuild counts its BFS's distance tests
    as ``rebuild_bfs_pairs``: under 0.1% of an all-pairs scan's (each
    expanded heavy atom against every unit-cell and supercell atom).
    With profiling off, the counter does not move."""
    system = pt.Input().load_file(DATA / "system_periodic.pdb")
    sc = create_supercell(system)
    expanded = []
    real = native.bfs_molecule

    def spy(*args, **kwargs):
        src, idx, pairs = real(*args, **kwargs)
        heavy, sheavy = args[4], args[8]
        expanded.append(int(heavy[idx[src == 0]].sum()) + int(sheavy[idx[src == 1]].sum()))
        return src, idx, pairs

    monkeypatch.setattr(native, "bfs_molecule", spy)
    saved = profiling.enabled()
    METRICS.reset()
    try:
        profiling.enable(False)
        discrete_molecules(system, rebuild=sc)
        assert "rebuild_bfs_pairs" not in METRICS.snapshot()["counters"]
        expanded.clear()
        profiling.enable()
        discrete_molecules(system, rebuild=sc)
        pairs = METRICS.snapshot()["counters"]["rebuild_bfs_pairs"]
    finally:
        profiling.enable(saved)
        METRICS.reset()
    all_pairs = sum(expanded) * (len(system["elements"]) + len(sc["elements"]))
    assert 0 < pairs < 1e-3 * all_pairs


def test_failed_build_raises(tmp_path, monkeypatch):
    """No compiler: the build raises with the cause, and a trajectory or
    a rebuild that needs the library raises too (nothing falls back)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    native.lib.cache_clear()
    try:
        with pytest.raises(native.NativeBuildError, match="no-such-compiler"):
            native.lib()
        with pytest.raises(native.NativeBuildError):
            pt.DLPOLY(HISTORY)
        system = pt.Input().load_file(DATA / "system.pdb")
        with pytest.raises(native.NativeBuildError):
            discrete_molecules(system)
        assert len(discrete_molecules(system, use_native=False)) == 1
        assert pt.DLPOLY(HISTORY, use_native=False).no_of_frames == 20
        assert not list((tmp_path / "native").glob("*.so"))
    finally:
        native.lib.cache_clear()
