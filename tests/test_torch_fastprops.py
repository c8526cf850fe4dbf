"""The native property-dict converter (``_native/fastprops.cpp`` through
``native.fastprops``): ``ops.analysis.to_properties_dicts_bulk`` against
its plain version and against the JAX package's converter, on packed
blocks with every marker and window state, in float32 and float64.
Equality is exact: the same keys, values, dtypes and warnings."""

import logging

import numpy as np
import pytest

from pywindow_torch import native
from pywindow_torch.ops import analysis as tanalysis
from pywindow_tpu.ops import analysis as janalysis


def _block(dtype, b=64, w=8, seed=0):
    """A packed (b, 21 + 6 w) block: random scalars and centres, atom
    indices, every any_open / saturation / overflow / budget state,
    refine failures and negative window diameters on some rows."""
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(b, 21 + 6 * w)) * 5.0
    flat[:, 7:11] = rng.integers(0, 500, (b, 4))
    flat[:, 11] = rng.random(b) > 0.2  # any_open
    flat[:, 12] = rng.integers(0, w + 1, b)  # n_clusters, w saturates
    flat[:, 13] = rng.random(b) > 0.9  # open overflow
    flat[:, 14] = rng.random(b) > 0.9  # fast budget hit
    flat[:, 21 + w : 21 + 2 * w] = rng.random((b, w)) > 0.4  # valid
    flat[:, 21 + 2 * w : 21 + 3 * w] = rng.random((b, w)) > 0.95  # refine failed
    return flat.astype(dtype), w


def _assert_same_dicts(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for key in g:
            gv, rv = g[key], r[key]
            if isinstance(gv, dict):
                assert sorted(gv) == sorted(rv)
                pairs = [(gv[k], rv[k]) for k in gv]
            else:
                pairs = [(gv, rv)]
            for a, b in pairs:
                if b is None:
                    assert a is None
                    continue
                assert type(a) is type(b), key
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype and a.shape == b.shape, key
                np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_equals_plain(dtype, caplog):
    flat, w = _block(dtype)
    calls = native.CALLS["props_dicts"]
    with caplog.at_level(logging.WARNING, logger="pywindow_torch"):
        got = tanalysis.to_properties_dicts_bulk(flat, w)
        n_native = len(caplog.records)
        caplog.clear()
        ref = tanalysis.to_properties_dicts_bulk_plain(flat, w)
        n_plain = len(caplog.records)
    assert native.CALLS["props_dicts"] == calls + 1
    assert n_native == n_plain > 0  # the same window warnings
    _assert_same_dicts(got, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_equals_jax_converter(dtype):
    flat, w = _block(dtype, seed=1)
    _assert_same_dicts(
        tanalysis.to_properties_dicts_bulk(flat, w),
        janalysis.to_properties_dicts_bulk(flat, w),
    )


def test_centre_arrays_are_views_of_the_block():
    """The dicts' centres are views into the block (so the sweep passes a
    block that no later chunk reuses)."""
    flat, w = _block(np.float64, b=4)
    got = tanalysis.to_properties_dicts_bulk(flat, w)
    assert np.shares_memory(got[0]["centre_of_mass"], flat)
    assert np.shares_memory(got[0]["pore_diameter_opt"]["centre_of_mass"], flat)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A converter that does not compile raises NativeBuildError with the
    compiler's output; nothing falls back to the plain version."""
    broken = tmp_path / "fastprops.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "FASTPROPS_SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.fastprops.cache_clear()
    try:
        with pytest.raises(native.NativeBuildError, match="exited with"):
            native.fastprops()
        flat, w = _block(np.float64, b=2)
        with pytest.raises(native.NativeBuildError):
            tanalysis.to_properties_dicts_bulk(flat, w)
    finally:
        native.fastprops.cache_clear()
