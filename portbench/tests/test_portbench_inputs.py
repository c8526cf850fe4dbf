"""The seeded generators: the same seed gives the same bytes, another
seed other bytes, and no two frames of a file are equal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.inputs import history, periodic, seeded, structures


def test_e12_4_prints_as_python_does():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=20000) * 8)
    x = torch.cat([x, torch.tensor([0.0, 9.99996, -9.99995e-3, 1.0, -100.0])])
    chars, printed = history.e12_4(x)
    got = [bytes(r).decode() for r in chars.numpy()]
    assert got == ["%12.4E" % v for v in x.numpy()]
    assert np.allclose(printed.numpy(), [float(s) for s in got], rtol=1e-15, atol=0)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, -5])
def test_history_same_seed_same_bytes(tmp_path, seed):
    a = history.write(tmp_path / "a", 40, seed, "HISTORY_singlemol_short", 5.0, "cpu")
    b = history.write(tmp_path / "b", 40, seed, "HISTORY_singlemol_short", 5.0, "cpu")
    c = history.write(tmp_path / "c", 40, seed + 1, "HISTORY_singlemol_short", 5.0, "cpu")
    assert a.path.read_bytes() == b.path.read_bytes() != c.path.read_bytes()
    flat = a.coords.reshape(40, -1)
    assert len(np.unique(flat, axis=0)) == 40
    assert sorted(np.bincount(a.source).tolist()) == [2] * 20
    got = history.read_frames(a, [0, 17, 39])
    assert np.allclose(np.stack(got), a.coords[[0, 17, 39]], rtol=0, atol=1e-12)


def test_history_is_read_by_the_port(tmp_path):
    import pywindow_torch as pt

    h = history.write(tmp_path / "h", 40, 3, "HISTORY_singlemol_short", 5.0, "cpu")
    traj = pt.DLPOLY(h.path)
    assert traj.no_of_frames == 40
    frame = traj.get_frames(frames=[7], swap_atoms={"he": "H"}, forcefield="OPLS")[7]
    assert np.allclose(frame.system["coordinates"], h.coords[7], rtol=0, atol=1e-9)


def test_rotations_are_rotations():
    r = seeded.rotations(seeded.rng(1), 50)
    assert np.allclose(r @ r.transpose(0, 2, 1), np.eye(3), atol=1e-12)
    assert np.allclose(np.linalg.det(r), 1.0)


def test_periodic_frames_wrapped_and_seeded(tmp_path):
    a = periodic.write(tmp_path / "a.pdb", 3, 9, "system_periodic.pdb")
    b = periodic.write(tmp_path / "b.pdb", 3, 9, "system_periodic.pdb")
    assert a.path.read_bytes() == b.path.read_bytes()
    assert a.coords.min() >= 0 and a.coords.max() <= a.edge
    assert not np.array_equal(a.coords[0], a.coords[1])


def test_structure_pool(tmp_path):
    els = np.array(["C"] * 168)
    p = structures.write(tmp_path, 20, 4, "HISTORY_singlemol_short", els, 5.0)
    assert len(p.paths) == 20 and sorted(p.source.tolist()) == list(range(20))
    line = p.paths[3].read_text().splitlines()[2].split()
    assert line[0] == "C" and np.allclose([float(v) for v in line[1:]], p.coords[3][0], atol=1e-12)
