"""The shape descriptors (``ops.geometry``), ``Molecule``'s shape and
alignment methods, ``load_rdkit_mol``, ``ops.encoding.encode`` and
``ops.cluster.dbscan_spiral``: pywindow_torch against pywindow_tpu on
the CPU in float64.

Tolerances: tensors and descriptors 1e-9 relative to their scale (the
same float64 formulas, reduced in another order); the rdkit path's
properties 1e-8 Å; DBSCAN labels exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pywindow_torch as pt
import pywindow_tpu as pw
from pywindow_torch.io.inputs import Input, rdkit_like_mol
from pywindow_torch.ops import cluster, geometry, rays
from pywindow_torch.ops.encoding import encode, encode_batch
from pywindow_tpu.ops import cluster as jcluster
from pywindow_tpu.ops import encoding as jencoding
from pywindow_tpu.ops import geometry as jgeometry
from tests.conftest import DATA, load_xyz

REL = 1e-9


def _molecules():
    rng = np.random.default_rng(3)
    asym = (np.array(["C", "N", "O", "H"] * 3), rng.normal(size=(12, 3)) * [3.0, 2.0, 1.0])
    return [load_xyz(DATA / "PUDXES.xyz"), load_xyz(DATA / "YAQHOQ.xyz"), asym]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_descriptors_match_jax(which):
    el, co = _molecules()[which]
    mol = encode(el, co, dtype=torch.float64, device="cpu")
    jmol = jencoding.encode(el, co)
    for name in ("coords", "mass", "vdw", "cov", "mask"):
        np.testing.assert_array_equal(getattr(mol, name).numpy(), np.asarray(getattr(jmol, name)))
    for name in ("gyration_tensor", "inertia_tensor"):
        got = getattr(geometry, name)(mol).numpy()
        ref = np.asarray(getattr(jgeometry, name)(jmol))
        np.testing.assert_allclose(got, ref, atol=REL * np.abs(ref).max(), rtol=0)
    eig = geometry.sorted_eigenvalues(geometry.inertia_tensor(mol))
    jeig = jgeometry.sorted_eigenvalues(jgeometry.inertia_tensor(jmol))
    scale = float(np.abs(np.asarray(jeig)).max())
    np.testing.assert_allclose(eig.numpy(), np.asarray(jeig), atol=REL * scale, rtol=0)
    for name in ("asphericity", "acylindricity"):
        assert float(getattr(geometry, name)(eig)) == pytest.approx(
            float(getattr(jgeometry, name)(jeig)), abs=REL * scale
        )
    assert float(geometry.relative_shape_anisotropy(eig)) == pytest.approx(
        float(jgeometry.relative_shape_anisotropy(jeig)), abs=REL
    )
    # the batched form equals the single one
    batched = geometry.inertia_tensor(encode_batch([(el, co)] * 2, device="cpu"))
    np.testing.assert_array_equal(batched[1].numpy(), geometry.inertia_tensor(mol).numpy())


@pytest.mark.parametrize("which", [0, 2])
def test_molecule_shape_and_alignment_match_jax(which):
    el, co = _molecules()[which]
    mine = pt.Molecule({"elements": el, "coordinates": co.copy()}, device="cpu")
    theirs = pw.Molecule({"elements": el, "coordinates": co.copy()})
    got, ref = mine.calculate_shape_descriptors(), theirs.calculate_shape_descriptors()
    assert sorted(got) == sorted(ref)
    scale = float(np.abs(np.linalg.eigvalsh(pt.utilities.get_inertia_tensor(el, co))).max())
    for key in got:
        assert got[key] == pytest.approx(ref[key], abs=REL * max(scale, 1.0))
    assert mine.properties["shape_descriptors"] is got
    if which == 2:  # distinct axes: the alignment is well defined
        mine._align_to_principal_axes()
        theirs._align_to_principal_axes()
        np.testing.assert_allclose(mine.coordinates, theirs.coordinates, atol=1e-8, rtol=0)
        assert mine.mol["coordinates"] is mine.coordinates
        assert mine.aligned_to_principal_axes
    with pytest.raises(NotImplementedError):
        mine._align_to_principal_axes(align_molsys=True)


@pytest.mark.parametrize("remove_hs", [True, False])
def test_load_rdkit_mol_matches_jax(remove_hs):
    """PUDXES.mol2 through an rdkit-shaped molecule (rdkit itself is not
    installed): both classes' ``load_rdkit_mol`` against the JAX
    package's, then the cheap properties of the whole system."""
    raw = Input().load_file(DATA / "PUDXES.mol2")
    rd = rdkit_like_mol(raw, remove_hs=remove_hs)
    mol = pt.Molecule.load_rdkit_mol(rd)
    jmol = pw.Molecule.load_rdkit_mol(rd)
    np.testing.assert_array_equal(mol.elements, jmol.elements)
    np.testing.assert_array_equal(mol.coordinates, jmol.coordinates)
    assert (mol.parent_system, mol.molecule_id) == (jmol.parent_system, jmol.molecule_id)
    assert mol.no_of_atoms == (84 if remove_hs else 168)
    sys_t = pt.MolecularSystem.load_rdkit_mol(rd).system_to_molecule()
    sys_j = pw.MolecularSystem.load_rdkit_mol(rd).system_to_molecule()
    np.testing.assert_allclose(
        sys_t.calculate_centre_of_mass(), sys_j.calculate_centre_of_mass(), atol=1e-12, rtol=0
    )
    d, _ = pt.utilities.pore_diameter(sys_t.elements, sys_t.coordinates, device="cpu")
    assert d == pytest.approx(5.3970201773100097, abs=1e-8)


def _spiral_case(n_points, radius, seed):
    """Spiral points of ``radius`` with patchy survivors (a few caps and
    some noise), made by the port (both DBSCANs take these points)."""
    rng = np.random.default_rng(seed)
    r = torch.tensor(radius, dtype=torch.float64)
    points = rays.golden_spiral(n_points, r)
    eps = rays.mean_knn_eps_scaled(n_points, r)
    dirs = rng.normal(size=(5, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    valid = ((points.numpy() / radius) @ dirs.T > 0.93).any(axis=1)
    valid |= rng.random(n_points) < 0.02
    return points, torch.as_tensor(valid), eps


@pytest.mark.parametrize("radius", [1.2, 11.1, 30.0])
@pytest.mark.parametrize("n_points", [120, 797])
def test_dbscan_spiral_matches_dense_and_jax(radius, n_points):
    points, valid, eps = _spiral_case(n_points, radius, n_points)
    nbr = cluster.spiral_neighbor_candidates(n_points)
    np.testing.assert_array_equal(nbr, jcluster.spiral_neighbor_candidates(n_points))
    labels, n = cluster.dbscan_spiral(points, valid, eps, nbr)
    dense, n_dense = cluster.dbscan(points, valid, eps)
    np.testing.assert_array_equal(labels.numpy(), dense.numpy())
    assert int(n) == int(n_dense)
    # the JAX function on the same inputs (its own spiral differs from
    # this one in the last bits of sin and cos)
    jl, jn = jcluster.dbscan_spiral(
        jnp.asarray(points.numpy()), jnp.asarray(valid.numpy()), jnp.asarray(float(eps)), nbr
    )
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    assert int(n) == int(jn)


def test_dbscan_spiral_batched_and_capped():
    """Frames as a leading axis equal frame-by-frame runs, and cluster
    ids at or past ``max_clusters`` fold to -1, as in the dense form."""
    cases = [_spiral_case(300, r, s) for r, s in ((4.0, 0), (9.0, 1), (12.0, 2))]
    points = torch.stack([c[0] for c in cases])
    valid = torch.stack([c[1] for c in cases])
    eps = torch.stack([c[2] for c in cases])
    nbr = cluster.spiral_neighbor_candidates(300)
    labels, n = cluster.dbscan_spiral(points, valid, eps, nbr, max_clusters=2)
    for i, (p, v, e) in enumerate(cases):
        one, n_one = cluster.dbscan_spiral(p, v, e, nbr, max_clusters=2)
        np.testing.assert_array_equal(labels[i].numpy(), one.numpy())
        dense, n_dense = cluster.dbscan(p, v, e, max_clusters=2)
        np.testing.assert_array_equal(one.numpy(), dense.numpy())
        assert int(n[i]) == int(n_one) == int(n_dense) <= 2
