"""Helpers shared by the ``test_torch_*`` parity tests: build the same
inputs for ``pywindow_tpu`` (JAX, under the conftest's CPU + x64) and
``pywindow_torch``, so that both packages compute on identical data;
and the test of ``pywindow_torch.convert``, which carries them across."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pywindow_torch.convert import config_from_dict, mol_arrays_from_numpy
from pywindow_tpu.ops import encoding as jenc

TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def both_encoded(elements, coords, dtype=np.float64):
    """(JAX MolArrays, torch MolArrays) of one molecule, encoded once by
    the JAX package and carried across with ``convert``."""
    jm = jenc.encode(elements, coords, dtype=np.dtype(dtype))
    tm = mol_arrays_from_numpy(
        *(np.asarray(a) for a in jm), device="cpu", dtype=TORCH_DTYPE[np.dtype(dtype)]
    )
    return jm, tm


def random_mol(n, seed, pad_to=None, dtype=np.float64):
    """A random blob of ``n`` atoms (numpy MolArrays fields), padded with
    parked atoms to ``pad_to`` -> (JAX MolArrays, torch MolArrays)."""
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(n, 3)) * 8
    vdw = rng.uniform(1.2, 2.0, n)
    pad = (pad_to or n) - n
    fields = (
        np.concatenate([coords, np.full((pad, 3), jenc.FAR_AWAY)]),
        np.concatenate([vdw, np.zeros(pad)]),
        np.concatenate([vdw, np.zeros(pad)]),
        np.concatenate([vdw, np.zeros(pad)]),
        np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
    )
    fields = tuple(f.astype(dtype) if f.dtype != bool else f for f in fields)
    jm = jenc.MolArrays(*fields)
    tm = mol_arrays_from_numpy(*fields, device="cpu", dtype=TORCH_DTYPE[np.dtype(dtype)])
    return jm, tm


def torch_config(jax_cfg):
    """The port's config carried across from a JAX AnalysisConfig."""
    return config_from_dict(dataclasses.asdict(jax_cfg))


def t(a, dtype=None):
    """numpy / JAX array -> CPU torch tensor."""
    a = np.array(a, dtype=dtype)
    return torch.from_numpy(a)


def test_convert_carries_config_and_molecule_across():
    """``convert`` rebuilds the JAX package's config and encoded
    molecule exactly, so both packages compute on the same inputs."""
    from pywindow_torch import config as tconfig
    from pywindow_torch.ops import encoding as tenc
    from pywindow_tpu.config import AnalysisConfig as JaxConfig
    from tests.conftest import load_structure

    jcfg = dataclasses.replace(JaxConfig(), max_windows=12, lb_z=False)
    cfg = torch_config(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg == tconfig.AnalysisConfig(max_windows=12, lb_z=False)

    elements, coords = load_structure("YAQHOQ")
    jm, tm = both_encoded(elements, coords)
    for a, b in zip(tm, tenc.encode_batch([(elements, coords)], device="cpu")):
        assert torch.equal(a, b[0])
    jm32, tm32 = both_encoded(elements, coords, np.float32)
    assert tm32.coords.dtype == torch.float32
    np.testing.assert_array_equal(tm32.coords.numpy(), np.asarray(jm32.coords))
