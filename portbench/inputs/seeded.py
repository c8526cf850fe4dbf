"""Seeded randomness of the inputs: one generator a run, from ``--seed``
(any whole number; negative seeds map onto the 64-bit range)."""

from __future__ import annotations

import numpy as np
import torch


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of ``stream`` for ``seed``: the same pair gives the
    same numbers."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def rotations(gen: np.random.Generator, n: int) -> np.ndarray:
    """n uniform random rotation matrices (n, 3, 3), from unit
    quaternions."""
    q = gen.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def moved_frames(
    gen: np.random.Generator, source: torch.Tensor, n: int, shift: float
) -> tuple[torch.Tensor, np.ndarray]:
    """n frames (n, atoms, 3) float64 on ``source``'s device, each a frame of ``source`` (S,
    atoms, 3) turned by its own uniform rotation about its centroid and
    moved by its own vector uniform in [-shift, shift]^3; every source
    frame is used equally often (n a multiple of S), in a seeded order.
    Returns (frames, the source index of each)."""
    s = source.shape[0]
    if n % s:
        msg = f"{n} frames is not a multiple of the {s} source frames"
        raise ValueError(msg)
    which = gen.permutation(np.repeat(np.arange(s), n // s))
    dev = source.device
    rot = torch.as_tensor(rotations(gen, n), device=dev)
    move = torch.as_tensor(gen.uniform(-shift, shift, size=(n, 1, 3)), device=dev)
    centred = source - source.mean(dim=1, keepdim=True)
    picked = centred[torch.as_tensor(which, device=dev)]
    return torch.einsum("fij,faj->fai", rot, picked) + move, which
