"""Carry the JAX package's state into the port.

pywindow has no weights: its state is the encoded molecule and the
analysis config.  These helpers rebuild both from plain numpy / dict
forms of the ``pywindow_tpu`` objects, so that both packages compute on
identical inputs (the parity tests use them); this module imports
nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from pywindow_torch.config import AnalysisConfig, default_dtype
from pywindow_torch.ops.encoding import MolArrays


def mol_arrays_from_numpy(
    coords,
    mass,
    vdw,
    cov,
    mask,
    device: torch.device | str,
    dtype: torch.dtype | None = None,
) -> MolArrays:
    """The port's :class:`MolArrays` from the numpy arrays of a
    ``pywindow_tpu`` ``MolArrays`` (e.g. ``[np.asarray(a) for a in mol]``)."""
    dtype = dtype or default_dtype(device)
    floats = (
        torch.tensor(np.asarray(a), device=device).to(dtype)
        for a in (coords, mass, vdw, cov)
    )
    mask_t = torch.tensor(np.asarray(mask, dtype=bool), device=device)
    return MolArrays(*floats, mask_t)


def config_from_dict(fields: dict) -> AnalysisConfig:
    """The port's config from ``dataclasses.asdict(jax_cfg)``."""
    return AnalysisConfig(**fields)
