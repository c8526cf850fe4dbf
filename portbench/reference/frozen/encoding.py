"""Host-side -> device-side molecule encoding.

Elements become integer ids once, per-atom mass/vdW/covalent radii are
looked up from the tables, and the molecule is padded to a static atom
count with a validity mask (counterpart of
``pywindow_tpu.ops.encoding``, encoding.py:23-113).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.frozen import tables
from portbench.reference.frozen.config import pad_multiple


class MolArrays(NamedTuple):
    """Padded, masked tensors of one molecule (or a batch of them).

    All fields share leading batch dims; the trailing atom axis is
    padded.  Padded slots have ``mask == False``, zero mass and radii,
    and coordinates parked at :data:`FAR_AWAY`, so they can never win a
    distance ``min``; max-style reductions must still apply ``mask``.
    """

    coords: torch.Tensor  # (..., N, 3)
    mass: torch.Tensor  # (..., N)
    vdw: torch.Tensor  # (..., N)
    cov: torch.Tensor  # (..., N)
    mask: torch.Tensor  # (..., N) bool

    @property
    def n_atoms(self) -> torch.Tensor:
        """Real (unpadded) atom count of each molecule."""
        return self.mask.sum(-1)

    def to(self, dtype: torch.dtype) -> MolArrays:
        """The same molecule with float fields cast to ``dtype``."""
        return MolArrays(
            *(t.to(dtype) if t.is_floating_point() else t for t in self)
        )


#: coordinate sentinel for padded atom slots.
FAR_AWAY = 1.0e6


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of *multiple* that is >= *n*."""
    return ((n + multiple - 1) // multiple) * multiple


def encode_host(
    elements: np.ndarray, coordinates: np.ndarray, n_pad: int, np_dtype
) -> tuple[np.ndarray, ...]:
    """One molecule's padded field arrays (coords, mass, vdw, cov, mask)
    as host numpy arrays."""
    ids = tables.element_ids(elements)
    n = len(ids)
    if n_pad < n:
        msg = f"pad_to={n_pad} smaller than atom count {n}"
        raise ValueError(msg)
    coords = np.full((n_pad, 3), FAR_AWAY, dtype=np_dtype)
    coords[:n] = np.asarray(coordinates, dtype=np_dtype)
    fields = [np.zeros(n_pad, dtype=np_dtype) for _ in range(3)]
    for field, table in zip(
        fields, (tables.ELEMENT_MASS, tables.ELEMENT_VDW, tables.ELEMENT_COV)
    ):
        field[:n] = table[ids]
    mask = np.zeros(n_pad, dtype=bool)
    mask[:n] = True
    return (coords, *fields, mask)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch float dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def encode(
    elements: np.ndarray,
    coordinates: np.ndarray,
    pad_to: int | None = None,
    dtype: torch.dtype | None = None,
    *,
    device: torch.device | str,
) -> MolArrays:
    """One molecule's padded fields on ``device``, without a batch axis
    (counterpart of ``pywindow_tpu.ops.encoding.encode``, encoding.py:79)."""
    return MolArrays(
        *(t[0] for t in encode_batch([(elements, coordinates)], pad_to, dtype, device=device))
    )


def encode_batch(
    systems: list[tuple[np.ndarray, np.ndarray]],
    pad_to: int | None = None,
    dtype: torch.dtype | None = None,
    *,
    device: torch.device | str,
) -> MolArrays:
    """Encode (elements, coordinates) pairs into one stacked (B, N_pad)
    batch on ``device``, padded to the largest member (counterpart of
    ``pywindow_tpu.ops.encoding.encode_batch``, encoding.py:95-113): the
    batch is assembled on the host and moved in one transfer per field."""
    dtype = dtype or torch.float64
    n_max = max(len(e) for e, _ in systems)
    n_pad = pad_to if pad_to is not None else round_up(max(n_max, 1), pad_multiple())
    per_mol = [encode_host(e, c, n_pad, numpy_dtype(dtype)) for e, c in systems]
    stacked = (np.stack(field) for field in zip(*per_mol))
    return MolArrays(*(torch.as_tensor(f, device=device) for f in stacked))


def unmasked(coords: torch.Tensor, vdw: torch.Tensor) -> MolArrays:
    """Flat (coords, vdw) as MolArrays with every atom valid: padded
    atoms, parked at :data:`FAR_AWAY` with vdW 0, cannot win a clearance
    minimum, so the kernels' inputs need no mask."""
    return MolArrays(coords, vdw, vdw, vdw, torch.ones_like(vdw, dtype=torch.bool))
