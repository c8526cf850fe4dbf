"""A seeded pool of single structures: moved frames of a HISTORY
fixture, their atom keys deciphered, written as XYZ files (``%.6f``)."""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from portbench.inputs import fixtures, seeded


@dataclasses.dataclass(frozen=True)
class Pool:
    """The written files, their elements, the coordinates as written
    (files, atoms, 3) float64 and the source frame of each file."""

    paths: list[pathlib.Path]
    elements: np.ndarray
    coords: np.ndarray
    source: np.ndarray


def write(
    folder: pathlib.Path, n: int, seed: int, fixture: str, elements: np.ndarray, shift: float
) -> Pool:
    """Write ``n`` XYZ files of moved ``fixture`` frames into ``folder``,
    each atom labelled with ``elements`` (the fixture's keys after the
    configuration's swap and force field)."""
    _, _, source = fixtures.history(fixture)
    frames, which = seeded.moved_frames(seeded.rng(seed, 3), torch.as_tensor(source), n, shift)
    printed = np.round(frames.numpy(), 6)
    paths = []
    for k, frame in enumerate(printed):
        lines = [str(len(elements)), f"structure {k}"]
        lines += [f"{e} {x:.6f} {y:.6f} {z:.6f}" for e, (x, y, z) in zip(elements, frame)]
        p = folder / f"s{k:04d}.xyz"
        p.write_text("\n".join(lines) + "\n")
        paths.append(p)
    return Pool(paths=paths, elements=np.asarray(elements), coords=printed, source=which)
