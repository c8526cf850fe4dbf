"""The ``clearance_min`` kernel (counterpart of
``pywindow_tpu.ops.pallas_kernels.clearance_min_pallas``).

:func:`clearance_min` is the vdW clearance field ``min_i(||x_i - p|| -
vdw_i)`` of a set of probe points against one molecule: the plain
version (:func:`clearance_min_plain`, the port's
``geometry.clearance_field`` with every atom valid) for CPU tensors, the
CUDA kernel (``csrc/clearance_min.cu``) for CUDA tensors, with no size
gate and no fallback.  As in the JAX package no pipeline stage calls it:
it is a public function for clearance grids and the like.
"""

from __future__ import annotations

import torch

from pywindow_torch.ops import _cuda
from pywindow_torch.ops.encoding import unmasked
from pywindow_torch.ops.geometry import clearance_field


def clearance_min_plain(
    probes: torch.Tensor, coords: torch.Tensor, vdw: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: probes (Q, 3), coords (N, 3), vdw (N,) ->
    (Q,).  It holds (Q, N, 3) differences at once."""
    return clearance_field(probes, unmasked(coords, vdw))


def clearance_min_cuda(
    probes: torch.Tensor, coords: torch.Tensor, vdw: torch.Tensor
) -> torch.Tensor:
    """The kernel on the card: probes (Q, 3), coords (N, 3), vdw (N,), all
    contiguous in the dtype of ``probes`` (float32 or float64) -> (Q,)."""
    dtype = probes.dtype
    device = _cuda.check_inputs(
        "clearance_min", dtype, probes=probes, coords=coords, vdw=vdw
    )
    q, n = probes.shape[0], coords.shape[0]
    _cuda.check_shape("clearance_min", probes, (q, 3), "probes")
    _cuda.check_shape("clearance_min", coords, (n, 3), "coords")
    _cuda.check_shape("clearance_min", vdw, (n,), "vdw")
    if n == 0:
        msg = "clearance_min: needs at least one atom"
        raise ValueError(msg)
    out = torch.empty(q, dtype=dtype, device=device)
    if q == 0:
        return out
    _cuda.load_extension().clearance_min(probes, coords, vdw, out)
    _cuda.LAUNCHES["clearance_min"] += 1
    return out


def clearance_min(
    probes: torch.Tensor, coords: torch.Tensor, vdw: torch.Tensor
) -> torch.Tensor:
    """``min_i(||x_i - p|| - vdw_i)`` per probe: probes (Q, 3), coords
    (N, 3), vdw (N,) -> (Q,), in the dtype of ``probes``.  Padded atoms
    must be parked far away (~1e6) with vdW 0, so they never win."""
    if _cuda.device_type("clearance_min", probes) == "cuda":
        return clearance_min_cuda(probes, coords, vdw)
    return clearance_min_plain(probes, coords, vdw)
