"""XYZ and PDB trajectories, the periodic path and the options of
``analysis_batched``: pywindow_torch against pywindow_tpu, and the
batched path against the serial one, on the CPU in float64.

Tolerances: 1e-8 Å for what no optimiser computes, 1e-4 Å for optimised
centres and windows (XLA's fused multiply-adds, amplified by the FD
gradients; see tests/test_torch_analysis.py).  Within the port, the
batched and serial paths run the same float64 arithmetic lane by lane
and are held to 1e-10 Å.
"""

import json

import numpy as np
import pytest

import pywindow_torch as pt
import pywindow_tpu as pw
from tests.conftest import DATA

HISTORY = DATA / "HISTORY_singlemol_short"
FF = {"swap_atoms": {"he": "H"}, "forcefield": "OPLS"}
EXACT = 1e-8
OPTIMISED = 1e-4
SAME = 1e-10


def periodic_trajectory(path, n_frames, seed=0):
    """``system_periodic.pdb`` as frame 0, then copies of its cell
    translated by a random vector and wrapped back into the cell, in the
    file's fixed columns, frames separated by END."""
    text = (DATA / "system_periodic.pdb").read_text()
    lines = text.splitlines()
    cryst = next(ln for ln in lines if ln.startswith("CRYST1"))
    atoms = [ln for ln in lines if ln[:6] in ("ATOM  ", "HETATM")]
    xyz = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atoms])
    a = float(cryst[6:15])
    rng = np.random.default_rng(seed)
    frames = [text[: text.rindex("END")] + "END\n"]
    for _ in range(1, n_frames):
        moved = np.mod(xyz + rng.uniform(0.0, a, 3), a)
        body = [ln[:30] + f"{x:8.3f}{y:8.3f}{z:8.3f}" + ln[54:] for ln, (x, y, z) in zip(atoms, moved)]
        frames.append("\n".join([cryst, *body, "END"]) + "\n")
    path.write_text("".join(frames))
    return path


def _xyz_trajectory(path):
    jtraj = pw.DLPOLY(HISTORY)
    blocks = []
    for f in (0, 3, 11):
        s = jtraj.get_frames(f, **FF)[f].system
        lines = [str(len(s["elements"])), f"frame {f}"]
        lines += [f"{el} {x:.6f} {y:.6f} {z:.6f}" for el, (x, y, z) in zip(s["elements"], s["coordinates"])]
        blocks.append("\n".join(lines))
    path.write_text("\n".join(blocks) + "\n")
    return path


def _close(got, ref, exact=EXACT, optimised=OPTIMISED):
    for key in ("average_diameter", "pore_volume"):
        assert got[key] == pytest.approx(ref[key], abs=exact)
    for key in ("maximum_diameter", "pore_diameter"):
        assert got[key]["diameter"] == pytest.approx(ref[key]["diameter"], abs=exact)
    np.testing.assert_allclose(got["centre_of_mass"], ref["centre_of_mass"], atol=exact, rtol=0)
    assert got["pore_diameter_opt"]["diameter"] == pytest.approx(
        ref["pore_diameter_opt"]["diameter"], abs=optimised
    )
    gw, rw = got["windows"]["diameters"], ref["windows"]["diameters"]
    assert (gw is None) == (rw is None)
    if gw is not None:
        assert len(gw) == len(rw)
        np.testing.assert_allclose(np.sort(gw), np.sort(rw), atol=optimised, rtol=0)
    assert got["no_of_atoms"] == ref["no_of_atoms"]


@pytest.mark.parametrize("fmt", ["xyz", "pdb"])
def test_maps_and_frames_match_jax(fmt, tmp_path):
    if fmt == "xyz":
        path = _xyz_trajectory(tmp_path / "t.xyz")
        traj, jtraj = pt.XYZ(path), pw.XYZ(path)
    else:
        path = periodic_trajectory(tmp_path / "t.pdb", 3)
        traj, jtraj = pt.PDB(path), pw.PDB(path)
    assert traj.no_of_frames == jtraj.no_of_frames == 3
    assert traj.trajectory_map == jtraj.trajectory_map
    got = traj.get_frames("all")
    ref = jtraj.get_frames("all")
    assert sorted(got) == sorted(ref) == [0, 1, 2]
    for f in ref:
        g, r = got[f].system, ref[f].system
        assert sorted(g) == sorted(r)
        for key in r:
            if key == "frame_info":
                assert g[key] == r[key]
            else:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(r[key]))


def test_periodic_frame_matches_jax():
    """``make_modular(rebuild=True)`` then ``analyze_molecules`` on one
    periodic frame: the same 8 cages as the JAX package, each within the
    behavioural parity bounds, and each on its row of the reference
    table (two orientations of the cage)."""
    system = pt.MolecularSystem.load_file(DATA / "system_periodic.pdb")
    system.make_modular(rebuild=True)
    got = system.analyze_molecules(device="cpu")
    jsystem = pw.MolecularSystem.load_file(DATA / "system_periodic.pdb")
    jsystem.make_modular(rebuild=True)
    ref = jsystem.analyze_molecules()
    assert sorted(got) == sorted(ref) == list(range(8))
    rows = {
        13.832017514255472: [3.6289651224, 3.6356210328, 3.6370723704, 3.6377874601],
        13.854084266982838: [3.6311549371, 3.6325120475, 3.6401548403, 3.6417727],
    }
    for key in ref:
        _close(got[key], ref[key])
        assert got[key]["no_of_atoms"] == 168
        assert system.molecules[key].pore_diameter_opt == got[key]["pore_diameter_opt"]["diameter"]
        avg = got[key]["average_diameter"]
        row = min(rows, key=lambda r: abs(r - avg))
        assert avg == pytest.approx(row, abs=1e-8)
        assert got[key]["pore_diameter_opt"]["diameter"] == pytest.approx(5.39702017731003, abs=1e-8)
        np.testing.assert_allclose(np.sort(got[key]["windows"]["diameters"]), rows[row], atol=1e-6)
    assert sorted(round(v["average_diameter"], 3) for v in got.values()) == [13.832] * 4 + [13.854] * 4


def test_periodic_batched_equals_serial(tmp_path):
    """A 2-frame periodic PDB trajectory through ``analysis_batched(
    modular=True, rebuild=True)`` equals ``analysis(...)`` molecule by
    molecule, with the JAX package's frame and molecule keys."""
    path = periodic_trajectory(tmp_path / "p.pdb", 2, seed=7)
    batched = pt.PDB(path)
    batched.analysis_batched(
        frames="all", batch_size=2, modular=True, rebuild=True, forcefield="DLF", device="cpu"
    )
    serial = pt.PDB(path)
    serial.analysis(frames=[0, 1], modular=True, rebuild=True, forcefield="DLF", device="cpu")
    jtraj = pw.PDB(path)
    assert sorted(batched.analysis_output) == [0, 1]
    for f in (0, 1):
        jsys = jtraj.get_frames(f, forcefield="DLF")[f]
        jsys.make_modular(rebuild=True)
        assert sorted(batched.analysis_output[f]) == sorted(jsys.molecules) == list(range(8))
        for key, ref in serial.analysis_output[f].items():
            _close(batched.analysis_output[f][key], ref, exact=SAME, optimised=SAME)


def test_exact_sizes_equal_serial():
    frames = [2, 10]
    batched = pt.DLPOLY(HISTORY)
    batched.analysis_batched(frames=frames, exact_sizes=True, device="cpu", **FF)
    serial = pt.DLPOLY(HISTORY)
    serial.analysis(frames=frames, device="cpu", **FF)
    for f in frames:
        _close(batched.analysis_output[f]["0"], serial.analysis_output[f]["0"], exact=SAME, optimised=SAME)


def test_autosave_resume_skips_saved_frames(tmp_path):
    save = tmp_path / "ckpt.json"
    first = pt.DLPOLY(HISTORY)
    first.analysis_batched(frames=[4, 9], batch_size=1, autosave=save, autosave_every=1, device="cpu", **FF)
    assert set(json.loads(save.read_text())) == {"4", "9"}
    resumed = pt.DLPOLY(HISTORY)
    resumed.load_analysis(save)
    kept = resumed.analysis_output[4]
    resumed.analysis_batched(frames=[4, 9, 13], device="cpu", **FF)
    assert resumed.analysis_output[4] is kept
    assert sorted(resumed.analysis_output) == [4, 9, 13]
    assert resumed.analysis_output[4]["0"]["pore_diameter_opt"]["diameter"] == pytest.approx(
        first.analysis_output[4]["0"]["pore_diameter_opt"]["diameter"], abs=1e-12
    )
    # override replaces a frame's entries whole
    resumed.analysis_batched(frames=[4], override=True, device="cpu", **FF)
    assert resumed.analysis_output[4] is not kept


def test_writers_match_jax_bytes(tmp_path):
    """``save_analysis``, ``dump_system`` (PDB, XYZ, modular or not) and
    ``dump_system_json`` write the JAX package's bytes."""
    system = pt.MolecularSystem.load_file(DATA / "system_periodic.pdb")
    jsystem = pw.MolecularSystem.load_file(DATA / "system_periodic.pdb")
    system.make_modular(rebuild=True)
    jsystem.make_modular(rebuild=True)
    for name, kwargs in (
        ("a.pdb", {}), ("b.pdb", {"modular": True}), ("c.xyz", {"modular": True}),
    ):
        system.dump_system(tmp_path / f"t_{name}", **kwargs)
        jsystem.dump_system(tmp_path / f"j_{name}", **kwargs)
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()
    system.dump_system_json(tmp_path / "t_sys", modular=True)
    jsystem.dump_system_json(tmp_path / "j_sys", modular=True)
    assert (tmp_path / "t_sys.json").read_bytes() == (tmp_path / "j_sys.json").read_bytes()
    mol, jmol = system.molecules[3], jsystem.molecules[3]
    mol.dump_molecule(tmp_path / "t_m.pdb")
    jmol.dump_molecule(tmp_path / "j_m.pdb")
    assert (tmp_path / "t_m.pdb").read_bytes() == (tmp_path / "j_m.pdb").read_bytes()
    assert mol.molecular_weight() == jmol.molecular_weight()
    np.testing.assert_array_equal(mol.calculate_centre_of_mass(), jmol.calculate_centre_of_mass())

    traj = pt.DLPOLY(HISTORY)
    traj.analysis_batched(frames=[2], device="cpu", **FF)
    jtraj = pw.DLPOLY(HISTORY)
    jtraj.analysis_output = traj.analysis_output
    traj.save_analysis(tmp_path / "t_an.json")
    jtraj.save_analysis(tmp_path / "j_an.json")
    assert (tmp_path / "t_an.json").read_bytes() == (tmp_path / "j_an.json").read_bytes()
    traj.save_frames([2], tmp_path / "tf.pdb", **FF)
    jtraj.save_frames([2], tmp_path / "jf.pdb", **FF)
    assert (tmp_path / "tf_2.pdb").read_bytes() == (tmp_path / "jf_2.pdb").read_bytes()
