"""The periodic rebuild: pywindow_torch's ``rebuild_system``,
``make_modular`` and ``discrete_molecules`` against the reference's
golden rebuild and against pywindow_tpu's, atom for atom.

The rebuild is host numpy and the native BFS in both packages, with the
same arithmetic, so the molecules must be equal exactly: the same atoms,
in the same order, with the same coordinates (the golden PDB stores 3
decimals, hence its 5.1e-4 Å)."""

import numpy as np
import pytest

import pywindow_torch as pt
import pywindow_tpu as pw
from pywindow_torch import native
from pywindow_torch.ops.cell import create_supercell
from pywindow_torch.ops.rebuild import connected_components_fast, discrete_molecules
from pywindow_tpu.ops.cell import create_supercell as jcreate_supercell
from pywindow_tpu.ops.rebuild import discrete_molecules as jdiscrete_molecules
from tests.conftest import DATA, load_pdb

_JAX_MOLECULES: dict = {}


def _jax_molecules(name, rebuild, use_native):
    key = (name, rebuild, use_native)
    if key not in _JAX_MOLECULES:
        system = pw.Input().load_file(DATA / f"{name}.pdb")
        sc = jcreate_supercell(system) if rebuild else None
        _JAX_MOLECULES[key] = jdiscrete_molecules(system, rebuild=sc, use_native=use_native)
    return _JAX_MOLECULES[key]


def test_rebuild_system_matches_the_golden_rebuild():
    rebuilt = pt.MolecularSystem.load_file(DATA / "system_periodic.pdb").rebuild_system()
    again = pt.MolecularSystem.load_system(rebuilt.system)
    again.make_modular()
    assert len(again.molecules) == 8
    assert all(mol.no_of_atoms == 168 for mol in again.molecules.values())
    gold_el, gold_co = load_pdb(DATA / "system_periodic_rebuild.pdb")
    np.testing.assert_array_equal(np.asarray(rebuilt.system["elements"], dtype="<U2"), gold_el)
    np.testing.assert_allclose(rebuilt.system["coordinates"], gold_co, atol=5.1e-4, rtol=0)


def test_make_modular_fragments_and_single_molecule():
    periodic = pt.MolecularSystem.load_file(DATA / "system_periodic.pdb")
    periodic.make_modular(rebuild=False)
    assert len(periodic.molecules) == 33
    assert sorted(periodic.molecules) == list(range(33))
    single = pt.MolecularSystem.load_file(DATA / "system.pdb")
    single.make_modular()
    assert len(single.molecules) == 1
    assert single.molecules[0].no_of_atoms == 168


def test_connected_components_counts():
    labels = connected_components_fast(pt.MolecularSystem.load_file(DATA / "system.pdb").system)
    assert len(set(labels)) == 1
    periodic = pt.MolecularSystem.load_file(DATA / "system_periodic.pdb").system
    assert len(set(connected_components_fast(periodic)) - {-1}) == 33


@pytest.mark.parametrize(
    ("name", "rebuild"),
    [("system_periodic", True), ("system_periodic", False), ("mol_system", False)],
)
@pytest.mark.parametrize("use_native", [True, False])
def test_discrete_molecules_match_jax(name, rebuild, use_native):
    """The port's native and numpy BFS against the JAX package's native
    and numpy BFS: the same molecules, atoms and order, exactly."""
    system = pt.Input().load_file(DATA / f"{name}.pdb")
    sc = create_supercell(system) if rebuild else None
    got = discrete_molecules(system, rebuild=sc, use_native=use_native)
    for jax_native in (True, False):
        ref = _jax_molecules(name, rebuild, jax_native)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert sorted(g) == sorted(r)
            for key in r:
                np.testing.assert_array_equal(g[key], r[key])


def _far_atom(system):
    """``system`` with one carbon 1e4 A from its centroid along every
    axis: the bin grid's extent then forces its bin cap."""
    far = {k: v for k, v in system.items() if k not in ("elements", "coordinates", "atom_ids")}
    far["elements"] = np.append(system["elements"], "C")
    far["atom_ids"] = np.append(system["atom_ids"], "C")
    tip = np.asarray(system["coordinates"]).mean(axis=0) + 1e4
    far["coordinates"] = np.vstack([system["coordinates"], tip])
    return far


#: the indexed BFS's cases: three seeded translated-and-wrapped frames
#: of the periodic cell (the benchmark's periodic trajectory), with and
#: without their supercell; a system with no cell; one with a far atom
INDEXED_CASES = [
    *[("frame", seed, rebuild) for rebuild in (True, False) for seed in (7, 2**31 + 5, 90210)],
    ("mol_system", None, False),
    ("far_atom", None, False),
]


@pytest.mark.parametrize(("kind", "seed", "rebuild"), INDEXED_CASES)
def test_indexed_bfs_matches_jax_all_pairs(kind, seed, rebuild, tmp_path):
    """The native BFS over its bin index against the JAX package's
    all-pairs native BFS: the same molecules, atoms and order, exactly."""
    from portbench.inputs import periodic

    if kind == "frame":
        path = periodic.write(tmp_path / "frame.pdb", 1, seed, "system_periodic.pdb").path
    else:
        path = DATA / ("mol_system.pdb" if kind == "mol_system" else "system.pdb")
    system, jsystem = pt.Input().load_file(path), pw.Input().load_file(path)
    if kind == "far_atom":
        system, jsystem = _far_atom(system), _far_atom(jsystem)
        index = native.BinIndex(system["coordinates"], None, 1.9)
        assert np.prod(index.dims) <= 2**20
        assert index.edge > 50 * 1.9
    sc = create_supercell(system) if rebuild else None
    jsc = jcreate_supercell(jsystem) if rebuild else None
    got = discrete_molecules(system, rebuild=sc)
    ref = jdiscrete_molecules(jsystem, rebuild=jsc, use_native=True)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for key in r:
            np.testing.assert_array_equal(g[key], r[key])


def test_cell_algebra_matches_jax():
    system = pt.Input().load_file(DATA / "system_periodic.pdb")
    jsystem = pw.Input().load_file(DATA / "system_periodic.pdb")
    from pywindow_torch.ops import cell
    from pywindow_tpu.ops import cell as jcell

    lattice = system["lattice"]
    frac = cell.cart_to_frac(system["coordinates"], lattice)
    np.testing.assert_array_equal(frac, jcell.cart_to_frac(jsystem["coordinates"], lattice))
    np.testing.assert_array_equal(cell.frac_to_cart(frac, lattice), jcell.frac_to_cart(frac, lattice))
    assert cell.volume_from_cell_parameters(system["unit_cell"]) == pytest.approx(24.8**3, rel=1e-12)
    assert cell.volume_from_lattice_array(lattice) == jcell.volume_from_lattice_array(lattice)
    sc, jsc = create_supercell(system), jcreate_supercell(jsystem)
    assert len(sc["elements"]) == 27 * 1344
    for key in jsc:
        np.testing.assert_array_equal(sc[key], jsc[key])
    two = pt.make_supercell(system, [2, 1, 1])
    jtwo = pw.make_supercell(jsystem, [2, 1, 1])
    np.testing.assert_array_equal(two.system["coordinates"], jtwo.system["coordinates"])
