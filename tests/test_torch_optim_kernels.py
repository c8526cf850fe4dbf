"""The plain versions of the port's optimiser and fine-path kernels
against pywindow_tpu's Pallas kernels (interpret mode on the CPU) on the
same numpy inputs, and the routing of the analysis through the kernel
wrappers.

Tolerances (float64): 1e-8 Å for the fine path (no optimiser: flags and
steps equal); 1e-4 Å for optimised points, since the JAX kernels' FD
gradients (h = 1e-8) amplify XLA's fused-multiply-add rounding by 1e8
(tests/test_torch_analysis.py explains the class of difference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pywindow_torch as pt
from pywindow_torch.ops import (
    _cuda,
    analysis,
    cluster,
    lbfgsb_kernels,
    nm_kernels,
    ray_kernels,
    windows,
)
from pywindow_tpu.ops import encoding as jenc
from pywindow_tpu.ops import geometry as jg
from pywindow_tpu.ops import lbfgsb_pallas, nm_pallas
from pywindow_tpu.ops import pallas_kernels as pk
from tests.conftest import DATA, load_structure
from tests.test_torch_parity import t

OPTIMISED = 1e-4
EXACT = 1e-8


def _pore_lanes():
    """PUDXES, YAQHOQ and BATVUP as one padded float64 batch with their
    pore-centre boxes (COM ± pore radius), as lbfgsb_pallas's
    pore_centres_pallas builds them."""
    mols = jenc.encode_batch(
        [load_structure(n) for n in ("PUDXES", "YAQHOQ", "BATVUP")], dtype=np.float64
    )
    com = np.stack([np.asarray(jg.center_of_mass(jenc.MolArrays(*(f[i] for f in mols)))) for i in range(3)])
    r = np.array(
        [float(jg.pore_diameter(jenc.MolArrays(*(f[i] for f in mols)))[0]) / 2 for i in range(3)]
    )[:, None]
    return np.asarray(mols.coords), np.asarray(mols.vdw), com, com - r, com + r


def _centred_lanes():
    """The same three molecules with their centres of mass at the origin
    (padded atoms stay parked), the frame the window stages work in."""
    coords, vdw, com, _, _ = _pore_lanes()
    real = vdw > 0
    coords = np.where(real[..., None], coords - com[:, None, :], coords)
    return coords, vdw


def test_lbfgsb_plain_matches_pallas_pore_lanes():
    coords, vdw, com, lo, hi = _pore_lanes()
    origin = np.zeros_like(com)
    ref = lbfgsb_pallas.lbfgsb_stable_flat(
        jnp.asarray(coords), jnp.asarray(vdw), jnp.asarray(origin), jnp.asarray(com),
        jnp.asarray(lo), jnp.asarray(hi), emb=lbfgsb_pallas.EMB_XYZ, sign=-1.0,
        maxiter=40, tile=8, interpret=True,
    )
    got = lbfgsb_kernels.lbfgsb_stable_flat_plain(
        t(coords), t(vdw), t(origin), t(com), t(lo), t(hi),
        emb=lbfgsb_kernels.EMB_XYZ, sign=-1.0, maxiter=40,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=OPTIMISED, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=OPTIMISED, rtol=0)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


def test_lbfgsb_plain_matches_pallas_z_lanes():
    """d = 1: the window-z embedding, from z = 0 with a lower bound and an
    'infinite' upper one, off-axis origins."""
    coords, vdw, _, _, _ = _pore_lanes()
    rng = np.random.default_rng(3)
    origin = np.concatenate([rng.normal(scale=0.3, size=(3, 2)), np.zeros((3, 1))], -1)
    x0 = np.zeros((3, 1))
    lo = -rng.uniform(1.0, 3.0, (3, 1))
    hi = np.full((3, 1), 1e10)
    ref = lbfgsb_pallas.lbfgsb_stable_flat(
        jnp.asarray(coords), jnp.asarray(vdw), jnp.asarray(origin), jnp.asarray(x0),
        jnp.asarray(lo), jnp.asarray(hi), emb=lbfgsb_pallas.EMB_Z, sign=1.0,
        maxiter=40, tile=8, interpret=True,
    )
    got = lbfgsb_kernels.lbfgsb_stable_flat_plain(
        t(coords), t(vdw), t(origin), t(x0), t(lo), t(hi),
        emb=lbfgsb_kernels.EMB_Z, sign=1.0, maxiter=40,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=OPTIMISED, rtol=0)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


def test_nm_plain_matches_pallas():
    """The fused 20 x 20 grid + Nelder-Mead polish on window lanes: the
    three cages about a z anchor, each with its grid half-width."""
    coords, vdw = _centred_lanes()
    z = np.array([0.1, -0.2, 0.05])
    half = np.array([1.2, 0.8, 1.5])
    ref = nm_pallas.nm_xy_flat(
        jnp.asarray(coords), jnp.asarray(vdw), jnp.asarray(z), jnp.asarray(half),
        maxiter=120, brute_ns=20, interpret=True,
    )
    got = nm_kernels.nm_xy_flat_plain(t(coords), t(vdw), t(z), t(half), brute_ns=20, maxiter=120)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=OPTIMISED, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=OPTIMISED, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_fine_path_plain_matches_pallas(monkeypatch):
    """The W-slot fine sweep against the frames-on-lanes kernel, as
    tests/test_pallas.py::test_fine_path_frames_on_lanes_matches_scan
    runs it (the kernel engaged below its 128-frame threshold)."""
    rng = np.random.RandomState(3)
    b, w, n, steps = 16, 8, 40, 24
    vectors = rng.randn(b, w, 3) * 5.0
    chunks = np.maximum(np.floor(np.linalg.norm(vectors, axis=-1) / 0.5), 1.0)
    coords = rng.randn(b, n, 3) * 6.0
    vdw = 1.0 + rng.rand(b, n)
    monkeypatch.setattr(pk, "_FINE_BATCH_MIN", 8)
    ok_j, pos_j, c_j = pk._fine_path_flat(
        jnp.asarray(vectors), jnp.asarray(chunks), jnp.asarray(coords), jnp.asarray(vdw), steps
    )
    ok, pos, cmin = ray_kernels.fine_path_plain(
        t(vectors), t(chunks.astype(np.int32)), t(coords), t(vdw), steps
    )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j) > 0.5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j).astype(np.int32))
    np.testing.assert_allclose(cmin.numpy(), np.asarray(c_j), atol=EXACT, rtol=0)


def _fake_kernels(monkeypatch):
    """Route every tensor to the ``*_cuda`` wrappers and stand each
    wrapper in by its plain version, counting launches as the wrappers
    do; the classic optimiser drivers refuse to run."""

    def counted(key, fn):
        def run(*args, **kwargs):
            _cuda.LAUNCHES[key] += 1
            return fn(*args, **kwargs)

        return run

    def refuse(*args, **kwargs):
        raise AssertionError("a plain FD optimiser ran on the kernel path")

    def ray_exit_plain(unit, rel, vdw, origin, want_exit, order):
        return ray_kernels.ray_exit_plain(unit, rel, vdw, origin, want_exit)

    monkeypatch.setattr(_cuda, "device_type", lambda name, tensor: "cuda")
    for module, attr, key, plain in (
        (ray_kernels, "ray_exit_cuda", "ray_exit", ray_exit_plain),
        (ray_kernels, "path_sweep_cuda", "path_sweep", ray_kernels.path_sweep_plain),
        (ray_kernels, "fine_path_cuda", "fine_path", ray_kernels.fine_path_plain),
        (lbfgsb_kernels, "lbfgsb_stable_flat_cuda", "lbfgsb_stable",
         lbfgsb_kernels.lbfgsb_stable_flat_plain),
        (nm_kernels, "nm_xy_flat_cuda", "nm_xy", nm_kernels.nm_xy_flat_plain),
    ):
        monkeypatch.setattr(module, attr, counted(key, plain))
    monkeypatch.setattr(
        "pywindow_torch.ops.cluster_kernels.dbscan_labels_cuda",
        counted("dbscan", lambda *a: cluster.dbscan(*a)[0]),
    )
    for module, attr in (
        (analysis, "lbfgsb_minimize"),
        (windows, "lbfgsb_minimize"),
        (windows, "brute_then_polish"),
    ):
        monkeypatch.setattr(module, attr, refuse)


def test_stable_stages_route_through_the_kernel_wrappers(monkeypatch):
    """With the card's configuration (float32 pipeline, stable
    optimisers) every stage of one molecule goes through a kernel
    wrapper: pore centre and window z through lbfgsb_stable, window xy
    through nm_xy, the fine re-sampling through fine_path, and the
    results equal the plain run's."""
    monkeypatch.setenv("PYWINDOW_TORCH_FORCE_F32", "1")
    path = DATA / "BATVUP.xyz"
    plain = pt.MolecularSystem.load_file(path).system_to_molecule().full_analysis(device="cpu")
    _fake_kernels(monkeypatch)
    _cuda.LAUNCHES.clear()
    routed = pt.MolecularSystem.load_file(path).system_to_molecule().full_analysis(device="cpu")
    assert dict(_cuda.LAUNCHES) == {
        "ray_exit": 2, "path_sweep": 1, "dbscan": 1, "fine_path": 1,
        "lbfgsb_stable": 2, "nm_xy": 1,
    }
    np.testing.assert_array_equal(
        routed["windows"]["diameters"], plain["windows"]["diameters"]
    )
    np.testing.assert_array_equal(
        routed["pore_diameter_opt"]["centre_of_mass"], plain["pore_diameter_opt"]["centre_of_mass"]
    )


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """full_analysis, analyze, analyze_batch and analysis_batched default
    to the card and raise when there is none; device="cpu" runs."""
    from pywindow_torch.parallel import batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    elements, coords = load_structure("YAQHOQ")
    mol = pt.Molecule({"elements": elements, "coordinates": coords})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mol.full_analysis()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        analysis.analyze(elements, coords)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.analyze_batch([(elements, coords)])
    traj = pt.DLPOLY(DATA / "HISTORY_singlemol_short")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        traj.analysis_batched(frames=[0], forcefield="OPLS", swap_atoms={"he": "H"})
    assert mol.full_analysis(device="cpu")["windows"]["diameters"] is None
