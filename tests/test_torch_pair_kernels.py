"""The ``max_dim`` kernel's plain versions and its algorithm on the CPU.

On CPU tensors ``geometry.max_dim`` and ``geometry.max_dim_value`` are
the plain versions of ``pywindow_torch.ops.pair_kernels``, equal bit for
bit to the eager all-pairs code frozen in the benchmark's reference
(``portbench.reference.frozen.geometry``), in float64 and float32.  The
plain versions' tie rule, all-masked frames and the two orders of the
value form are pinned on the adversarial frames of
``chip_smoke.max_dim_cases``; on the same frames
:func:`~pywindow_torch.ops.pair_kernels.max_dim_mirror` (the kernel's
tiles, the entries it visits, its argmax order, its reductions folded in
random orders) equals the plain versions bit for bit, NaN where they are
NaN.  The kernel itself is held to the plain versions on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 3).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from portbench.reference.frozen import geometry as frozen
from pywindow_torch.ops import _cuda, geometry
from pywindow_torch.ops import pair_kernels as pk
from pywindow_torch.ops.encoding import MolArrays, encode, encode_batch
from tests.conftest import load_structure

DTYPES = [torch.float64, torch.float32]
CASES = [label for label, _ in chip_smoke.max_dim_cases(torch.float64, "cpu")]


def _molecules(case, dtype):
    """PUDXES or MIBQAR alone (no frame axis), or a batch of five seeded
    frames of YAQHOQ with the third frame's atoms all masked."""
    if case != "batch":
        return encode(*load_structure(case), dtype=dtype, device="cpu")
    elements, coords = load_structure("YAQHOQ")
    rng = np.random.default_rng(5)
    mols = encode_batch(
        [(elements, coords + rng.normal(scale=0.2, size=coords.shape)) for _ in range(5)],
        dtype=dtype, device="cpu",
    )
    mols.mask[2] = False
    return mols


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["PUDXES", "MIBQAR", "batch"])
def test_geometry_max_dim_is_the_plain_and_the_frozen_code(case, dtype):
    mol = _molecules(case, dtype)
    got = geometry.max_dim(mol)
    for ref in (pk.max_dim_plain(mol), frozen.max_dim(mol)):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    value = geometry.max_dim_value(mol)
    assert torch.equal(value, pk.max_dim_value_plain(mol))
    assert torch.equal(value, frozen.max_dim_value(mol))
    assert got[0].shape == value.shape == mol.mask.shape[:-1]


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_ties_masks_and_orders(dtype):
    """Equal maxima go to the first row-major entry, in another tile than
    the later one too; an all-masked frame gives -1e30 at atoms (0, 0);
    valid sums below -1e30 lose to the first -1e30 entry, (1, 0) or a
    masked atom of row 0; the value form's maximum is the lower
    triangle's order where the two orders round apart."""
    cases = dict(chip_smoke.max_dim_cases(dtype, "cpu"))
    big = torch.tensor(-1.0e30, dtype=dtype)

    def atoms(label):
        value, a1, a2 = pk.max_dim_flat_plain(*cases[label], True)
        return value, list(zip(a1.tolist(), a2.tolist()))

    value, found = atoms("ties")
    assert found == [(100, 290), (3, 7)] and value.tolist() == [23.0, 23.0]
    value, found = atoms("all masked")
    assert found == [(0, 0), (0, 0)] and bool((value == big).all())
    value, found = atoms("below -1e30")
    assert found == [(1, 0), (0, 6)] and bool((value == big).all())
    coords, vdw, mask = cases["two orders"]
    value, found = atoms("two orders")
    full = pk.max_dim_flat_plain(coords, vdw, mask, False)[0]
    x, a, b = coords[0, 200, 0], vdw[0, 5], vdw[0, 200]
    assert found == [(5, 200)] and value[0] == (x + a) + b
    assert full[0] == (x + b) + a > value[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("label", CASES)
def test_mirror_equals_the_plain_versions_in_any_order(label, dtype):
    coords, vdw, mask = dict(chip_smoke.max_dim_cases(dtype, "cpu"))[label]
    tiles = (2, 3, 8, pk.TILE) if mask.shape[1] <= 64 else (8, pk.TILE)
    for atoms in (True, False):
        ref = pk.max_dim_flat_plain(coords, vdw, mask, atoms)
        for seed, tile in enumerate(tiles):
            for generator in (None, torch.Generator().manual_seed(seed)):
                got = pk.max_dim_mirror(coords, vdw, mask, atoms, tile, generator)
                assert all(chip_smoke.same_values(g, r) for g, r in zip(got, ref)), (atoms, tile)


def test_entry_points_keep_the_leading_axes(monkeypatch):
    """The card's branch of the entry points: leading axes flattened into
    the kernel's frame axis and restored (the kernel stood in for by its
    plain form); and its wrapper refuses CPU tensors."""
    mol = _molecules("batch", torch.float64)
    stacked = MolArrays(*(t.reshape(1, *t.shape) for t in mol))
    monkeypatch.setattr(_cuda, "device_type", lambda name, t: "cuda")
    monkeypatch.setattr(pk, "max_dim_cuda", pk.max_dim_flat_plain)
    for m in (stacked, MolArrays(*(t[1] for t in mol))):
        got = geometry.max_dim(m)
        assert all(torch.equal(g, r) for g, r in zip(got, pk.max_dim_plain(m)))
        assert torch.equal(geometry.max_dim_value(m), pk.max_dim_value_plain(m))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="one CUDA device"):
        pk.max_dim_cuda(mol.coords, mol.vdw, mol.mask, True)
