"""The ``mibqar_md`` configuration: its fixture is what
``portbench/inputs/thermal.py`` writes.  Its cell's tiny CPU runs are
``test_portbench_drivers.py``'s, at the size ``portbench/conftest.py``
gives it."""

from __future__ import annotations

import numpy as np

from portbench.inputs import fixtures, thermal


def test_fixture_is_written_again_byte_for_byte():
    committed = (fixtures.DATA / thermal.NAME).read_text()
    assert thermal.text(*thermal.frames()) == committed
    _, atom_lines, coords = fixtures.history(thermal.NAME)
    assert coords.shape == (thermal.FRAMES, 424, 3)
    assert sorted(set(fixtures.atom_keys(atom_lines))) == ["C", "H", "O", "Zn"]
    assert len(np.unique(coords.reshape(thermal.FRAMES, -1), axis=0)) == thermal.FRAMES


def test_displacements_are_thermal():
    """The displacements from the structure spread as the stated sigma."""
    elements, moved = thermal.frames()
    _, base = thermal.frames(sigma=0.0)
    d = moved - base
    assert abs(d.std() - thermal.SIGMA_A) < 0.005 and abs(d.mean()) < 0.005
    assert elements.tolist().count("Zn") == 32
