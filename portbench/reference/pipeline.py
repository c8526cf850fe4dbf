"""The plain reference of the analysis: the frozen plain pipeline
(:mod:`portbench.reference.frozen`) over molecules the benchmark made,
in blocks of rows, at the sampling sizes the timed route derives.

It imports nothing of the program.  It runs the stable optimisers (the
card's algorithm) with the open-ray compaction off and the full
iteration budgets, which give what the program's re-runs settle on;
it escalates the window slots as the program does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.frozen import config, tables
from portbench.reference.frozen.analysis import (
    batch_sizes,
    full_analysis_device,
    max_dim_host,
    pack_results,
    packed_size,
    static_sizes,
)
from portbench.reference.frozen.encoding import encode_batch

#: the program's defaults with the compaction off and the full budgets
CFG = dataclasses.replace(config.DEFAULT_CONFIG, open_cap_frac=1.0, fast_budgets=False)
#: frames a reference block holds (the plain versions keep (lanes, rays,
#: steps or atoms) tensors)
BLOCK = 32

__all__ = [
    "analyse",
    "batch_sizes",
    "max_dim_bound",
    "max_dim_host",
    "molecular_weight",
    "static_sizes",
]


def max_dim_bound(elements: np.ndarray, coordinates: np.ndarray) -> float:
    """The bounding-box diagonal plus two of the largest vdW radii: the
    bound the generic route sizes its ray paths by."""
    ids = tables.element_ids(elements)
    c = np.asarray(coordinates, dtype=np.float64)
    diag = float(np.linalg.norm(c.max(axis=0) - c.min(axis=0)))
    return diag + 2.0 * float(tables.ELEMENT_VDW[ids].max())


def molecular_weight(elements: np.ndarray) -> float:
    """Sum of the atomic masses, in float64."""
    return float(tables.ELEMENT_MASS[tables.element_ids(elements)].sum())


def _unpack(row: np.ndarray, w: int) -> dict:
    off = packed_size(0)
    valid = row[off + w : off + 2 * w] > 0.5
    return {
        "molecular_weight": row[0],
        "maximum_diameter": row[1],
        "average_diameter": row[2],
        "pore_diameter": row[3],
        "pore_diameter_opt": row[5],
        "any_open": row[11] > 0.5,
        "n_clusters": int(round(float(row[12]))),
        "centre_of_mass": row[15:18],
        "pore_opt_centre": row[18:21],
        "window_diameters": row[off : off + w][valid],
        "window_centres": row[off + 3 * w : off + 6 * w].reshape(w, 3)[valid],
    }


def analyse(
    systems: list[tuple[np.ndarray, np.ndarray]],
    sizes: tuple[int, int, int, int],
    device: torch.device | str,
    dtype: torch.dtype = torch.float64,
    opt_dtype: torch.dtype = torch.float64,
) -> list[dict]:
    """One result dict a system (``molecular_weight``, diameters, centres,
    the valid windows' diameters and centres) at ``sizes``, the pipeline
    in ``dtype`` and the optimisers in ``opt_dtype`` (the control lowers
    both)."""
    saved = config.OPT_DTYPE
    config.OPT_DTYPE = opt_dtype
    try:
        out: list[dict] = []
        for lo in range(0, len(systems), BLOCK):
            part = systems[lo : lo + BLOCK]
            cfg = CFG
            while True:
                mols = encode_batch(part, dtype=torch.float64, device=device).to(dtype)
                with torch.no_grad():
                    flat = pack_results(full_analysis_device(mols, *sizes, cfg))
                rows = flat.to(torch.float64).cpu().numpy()
                saturated = np.rint(rows[:, 12]) >= cfg.max_windows
                if not saturated.any() or cfg.max_windows >= config.MAX_WINDOWS_CEILING:
                    break
                cfg = dataclasses.replace(cfg, max_windows=2 * cfg.max_windows)
            out.extend(_unpack(r, cfg.max_windows) for r in rows)
            del mols, flat
        return out
    finally:
        config.OPT_DTYPE = saved
