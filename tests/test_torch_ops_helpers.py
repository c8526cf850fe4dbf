"""The small ``ops`` helpers of the port against the JAX package's, in
float64 on the CPU on the same inputs: ``optimise_pore_centre``,
``pore_diameter_opt``, ``packed_size``, ``pore_stable_probe``,
``mean_knn_eps``, ``ray_sphere_intersections`` and
``MolArrays.n_atoms``.

Tolerances: centres and diameters 1e-8 Å on PUDXES, where the classic
FD driver is not chaotic; the probe's Δf and gradient and the k-NN eps
1e-12 relative (the same formulas in another summation order); the
hit and front flags equal, exit distances 1e-10 Å on the hits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywindow_torch.config import AnalysisConfig
from pywindow_torch.ops import analysis as tana
from pywindow_torch.ops import encoding as tenc
from pywindow_torch.ops import geometry as tg
from pywindow_torch.ops import lbfgsb_kernels
from pywindow_torch.ops import rays as trays
from pywindow_tpu.ops import analysis as jana
from pywindow_tpu.ops import encoding as jenc
from pywindow_tpu.ops import geometry as jg
from pywindow_tpu.ops import rays as jrays
from tests.conftest import load_structure
from tests.test_torch_parity import both_encoded, random_mol, t

CENTRE = 1e-8
REL = 1e-12
EXIT = 1e-10


def _batched(tm: tenc.MolArrays) -> tenc.MolArrays:
    return tenc.MolArrays(*(f[None] for f in tm))


def test_optimise_pore_centre_and_pore_diameter_opt():
    jm, tm = both_encoded(*load_structure("PUDXES"))
    tm = _batched(tm)
    centre = tana.optimise_pore_centre(tm)
    assert centre.shape == (1, 3)
    np.testing.assert_allclose(
        centre[0].numpy(), np.asarray(jana.optimise_pore_centre(jm)), atol=CENTRE, rtol=0
    )
    d, atom, at, capped = tana.pore_diameter_opt(tm)
    jd, jatom, jat, jcapped = jana.pore_diameter_opt(jm)
    assert float(d[0]) == pytest.approx(float(jd), abs=CENTRE)
    # the limiting atom: one that attains the minimum (on the symmetric
    # cage several atoms tie to the last bit)
    gap = tg.pairwise_distances(at, tm.coords)[0, 0] - tm.vdw[0]
    assert 2 * float(gap[int(atom[0])]) == pytest.approx(float(jd), abs=CENTRE)
    assert 2 * float(gap[int(jatom)]) == pytest.approx(float(d[0]), abs=CENTRE)
    np.testing.assert_allclose(at[0].numpy(), np.asarray(jat), atol=CENTRE, rtol=0)
    assert bool(capped[0]) == bool(jcapped)
    # the pipeline's optimised pore is the same call's
    assert torch.equal(at, centre)
    assert float(d[0]) == pytest.approx(5.397020177310022, abs=1e-6)


@pytest.mark.parametrize("w", range(1, 13))
def test_packed_size(w):
    assert tana.packed_size(w) == jana.packed_size(w)


def test_packed_size_is_the_pipeline_row():
    """A pipeline row has ``packed_size(max_windows)`` values, and the
    native converter refuses a block of another width."""
    from pywindow_torch import native

    elements, coords = load_structure("YAQHOQ")
    cfg = AnalysisConfig(max_windows=5)
    mol = tenc.encode_batch([(elements, coords)], device="cpu")
    sizes = tana.static_sizes(tana.max_dim_host(elements, coords), cfg)
    flat = tana.run_pipeline(mol, sizes, cfg).numpy()
    assert flat.shape == (1, tana.packed_size(5))
    with pytest.raises(ValueError, match="window slots"):
        native.props_dicts(flat, 4)


@pytest.mark.parametrize("case", ["PUDXES", "random"])
def test_pore_stable_probe_matches_jax(case):
    jm, tm = random_mol(40, seed=5, pad_to=48) if case == "random" else both_encoded(*load_structure(case))
    rng = np.random.default_rng(11)
    centre = np.asarray(jg.center_of_mass(jm))
    x = centre + rng.normal(scale=0.3, size=(4, 3))
    disp = rng.normal(scale=0.05, size=(4, 3))
    disp[0] = 0.0
    disp[1] *= 1e-7
    h = rng.uniform(0.5e-8, 2e-8, size=(4, 3))
    probe = tg.pore_stable_probe(_batched(tm))
    got_f, got_g = probe(t(x), t(disp), t(h))
    jprobe = jg.pore_stable_probe(jm)
    for i in range(4):
        want_f, want_g = jprobe(jnp.asarray(x[i]), jnp.asarray(disp[i]), jnp.asarray(h[i]))
        assert float(got_f[i]) == pytest.approx(float(want_f), rel=REL, abs=1e-300)
        np.testing.assert_allclose(got_g[i].numpy(), np.asarray(want_g), rtol=REL, atol=0)


def test_lbfgsb_plain_probes_through_pore_stable_probe(monkeypatch):
    """The ``lbfgsb_stable`` kernel's plain version builds its probe with
    ``pore_stable_probe`` (window z: the z embedding about an origin)."""
    seen = []
    real = lbfgsb_kernels.pore_stable_probe

    def spy(*args, **kwargs):
        seen.append(args[1:])
        return real(*args, **kwargs)

    monkeypatch.setattr(lbfgsb_kernels, "pore_stable_probe", spy)
    _, tm = both_encoded(*load_structure("PUDXES"))
    tm = _batched(tm)
    origin = tg.center_of_mass(tm)
    x0 = torch.zeros(1, 1, dtype=torch.float64)
    lbfgsb_kernels.lbfgsb_stable_flat(
        tm.coords, tm.vdw, origin, x0, x0 - 1.0, x0 + 1.0,
        emb=lbfgsb_kernels.EMB_Z, sign=1.0, maxiter=5,
    )
    assert len(seen) == 1 and seen[0][0] == 1.0 and torch.equal(seen[0][1], origin)


@pytest.mark.parametrize("n_points,k", [(64, 10), (300, 10), (300, 4)])
def test_mean_knn_eps_matches_jax(n_points, k):
    radius = 7.25
    pts = np.asarray(jrays.golden_spiral(n_points, radius, jnp.float64))
    got = trays.mean_knn_eps(t(pts), k)
    assert float(got) == pytest.approx(float(jrays.mean_knn_eps(jnp.asarray(pts), k)), rel=REL)
    # the scaled form the pipeline takes
    scaled = trays.mean_knn_eps_scaled(n_points, torch.tensor(radius, dtype=torch.float64), k)
    assert float(scaled) == pytest.approx(float(got), rel=REL)
    # a batch of point sets
    rng = np.random.default_rng(3)
    sets = rng.normal(size=(3, 50, 3))
    got = trays.mean_knn_eps(t(sets), k)
    for i in range(3):
        assert float(got[i]) == pytest.approx(float(jrays.mean_knn_eps(jnp.asarray(sets[i]), k)), rel=REL)


@pytest.mark.parametrize("case", ["PUDXES", "NUXHIZ", "random"])
def test_ray_sphere_intersections_match_jax(case):
    jm, tm = random_mol(61, seed=3, pad_to=72) if case == "random" else both_encoded(*load_structure(case))
    radius = float(jg.max_dim_value(jm))
    pts = np.asarray(jrays.golden_spiral(500, radius, jnp.float64))
    got = trays.ray_sphere_intersections(t(pts)[None], _batched(tm))
    want = jrays.ray_sphere_intersections(jnp.asarray(pts), jm)
    assert got.hits.shape == (1, 500, tm.coords.shape[0])
    hits = np.asarray(want.hits)
    np.testing.assert_array_equal(got.hits[0].numpy(), hits)
    np.testing.assert_array_equal(got.front[0].numpy(), np.asarray(want.front))
    assert hits.any() and not hits[:, ~np.asarray(jm.mask)].any()
    np.testing.assert_allclose(
        got.exit_norm[0].numpy()[hits], np.asarray(want.exit_norm)[hits], atol=EXIT, rtol=0
    )
    # the pairs the ray_exit plain version reduces over
    any_front, _ = trays.reversed_exit_distance(t(pts)[None], _batched(tm))
    assert torch.equal(got.front.any(-1), any_front)


def test_n_atoms_on_a_padded_batch():
    systems = [load_structure(name) for name in ("PUDXES", "YAQHOQ", "NUXHIZ")]
    mols = tenc.encode_batch(systems, device="cpu")
    want = [int(jenc.encode(e, c, pad_to=mols.coords.shape[1]).n_atoms) for e, c in systems]
    assert mols.n_atoms.tolist() == want == [len(e) for e, _ in systems]
    assert mols.n_atoms.dtype == torch.int64
