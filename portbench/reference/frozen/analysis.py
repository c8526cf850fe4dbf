"""Full analysis of a batch of molecules (frozen copy of
``pywindow_torch/ops/analysis.py``, reference: molecular.py:156-202):
``full_analysis_device`` computes every property of a batch of B
molecules (B, N) with no loop over frames, ``pack_results`` flattens
them, and the sizing helpers give the sampling sizes the program's
routes derive."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.frozen import tables
from portbench.reference.frozen import config
from portbench.reference.frozen.config import (
    DEFAULT_CONFIG,
    AnalysisConfig,
    effective_budgets,
)
from portbench.reference.frozen import rays
from portbench.reference.frozen.encoding import MolArrays
from portbench.reference.frozen.geometry import (
    center_of_mass,
    max_dim,
    max_dim_value,
    molecular_weight,
    pore_diameter,
    shift_to,
    sphere_volume,
)
from portbench.reference.frozen.lbfgsb_kernels import EMB_XYZ, lbfgsb_stable_flat
from portbench.reference.frozen.windows import WindowsResult, find_windows


class FullAnalysis(NamedTuple):
    """Everything ``full_analysis`` computes."""

    molecular_weight: torch.Tensor
    centre_of_mass: torch.Tensor  # (3,)
    maxd_atom_1: torch.Tensor
    maxd_atom_2: torch.Tensor
    maximum_diameter: torch.Tensor
    average_diameter: torch.Tensor
    pore_diameter: torch.Tensor
    pore_atom: torch.Tensor
    pore_volume: torch.Tensor
    pore_opt_diameter: torch.Tensor
    pore_opt_atom: torch.Tensor
    pore_opt_centre: torch.Tensor  # (3,)
    pore_opt_volume: torch.Tensor
    windows: WindowsResult


def optimise_pore_centre_res(
    mol: MolArrays,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    start: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The optimised pore centres (B, 3) of a batch (L-BFGS-B from the
    COM within a ±pore_r box; reference: utilities.py:400-426) and the
    flags (B,) that the (possibly fast) iteration budget stopped them.
    ``start`` = (x0, lower, upper), each (B, 3), replaces the COM start
    and its box.

    Runs the stable driver in ``config.OPT_DTYPE``.
    """
    opt_maxiter, _ = effective_budgets(cfg)
    omol = mol.to(config.OPT_DTYPE)
    if start is None:
        com = center_of_mass(omol)
        pd0, _ = pore_diameter(omol, com=com)
        pore_r = (pd0 / 2.0)[:, None]
        x0, lower, upper = com, com - pore_r, com + pore_r
    else:
        x0, lower, upper = (t.to(config.OPT_DTYPE) for t in start)
    x, _, _, _, capped = lbfgsb_stable_flat(
        omol.coords, omol.vdw, torch.zeros_like(x0), x0, lower, upper,
        emb=EMB_XYZ, sign=-1.0, maxiter=opt_maxiter,
    )
    return x.to(mol.coords.dtype), capped


def full_analysis_device(
    mol: MolArrays,
    n_points_windows: int,
    n_points_avg: int,
    l1: int,
    l2: int,
    cfg: AnalysisConfig,
) -> FullAnalysis:
    """Every per-molecule property of the batch ``mol`` (B, N), computed
    on its device."""
    mw = molecular_weight(mol)
    com = center_of_mass(mol)
    a1, a2, maxd = max_dim(mol)

    # average diameter on the COM-centred molecule, sampling radius =
    # the full max diameter (utilities.py:1586-1650)
    centred = shift_to(mol, torch.zeros_like(com))
    avg = rays.average_diameter(centred, n_points_avg, max_dim_value(centred))

    pd, pd_atom = pore_diameter(mol, com=com)
    pv = sphere_volume(pd / 2.0)
    pod_centre, pore_capped = optimise_pore_centre_res(mol, cfg)
    pod, pod_atom = pore_diameter(mol, com=pod_centre)
    pov = sphere_volume(pod / 2.0)

    wins = find_windows(
        mol, n_points_windows, l1, l2, cfg, pore_centre=pod_centre
    )
    wins = wins._replace(opt_capped=wins.opt_capped | pore_capped)
    return FullAnalysis(
        molecular_weight=mw,
        centre_of_mass=com,
        maxd_atom_1=a1,
        maxd_atom_2=a2,
        maximum_diameter=maxd,
        average_diameter=avg,
        pore_diameter=pd,
        pore_atom=pd_atom,
        pore_volume=pv,
        pore_opt_diameter=pod,
        pore_opt_atom=pod_atom,
        pore_opt_centre=pod_centre,
        pore_opt_volume=pov,
        windows=wins,
    )


def packed_size(max_windows: int) -> int:
    """Length of a packed result row (:func:`pack_results`): 15 scalars,
    the COM and the optimised centre, then 6 values a window slot."""
    return 21 + 6 * max_windows


def pack_results(res: FullAnalysis) -> torch.Tensor:
    """Flatten a batched FullAnalysis into one (B, packed_size(W)) float
    tensor, so the host fetches one tensor.  Row layout: 15 scalars, COM
    (3), optimised centre (3), then per-window diameters / valid /
    refine_failed / centres (W slots)."""
    w = res.windows
    f = res.pore_diameter.dtype
    scalars = [
        res.molecular_weight,
        res.maximum_diameter,
        res.average_diameter,
        res.pore_diameter,
        res.pore_volume,
        res.pore_opt_diameter,
        res.pore_opt_volume,
        res.maxd_atom_1,
        res.maxd_atom_2,
        res.pore_atom,
        res.pore_opt_atom,
        w.any_open,
        w.n_clusters,
        w.open_overflow,
        w.opt_capped,
    ]
    return torch.cat(
        [
            torch.stack([s.to(f) for s in scalars], -1),
            res.centre_of_mass,
            res.pore_opt_centre,
            w.diameters,
            w.valid.to(f),
            w.refine_failed.to(f),
            w.centers.flatten(-2),
        ],
        -1,
    )


def run_pipeline(
    mols: MolArrays, sizes: tuple[int, int, int, int], cfg: AnalysisConfig
) -> torch.Tensor:
    """The device pipeline of one batch: (B, N) molecules -> packed
    (B, packed_size(W)) results on their device.  The single-molecule path and
    every chunk of a sweep run through here, so each kernel launches the
    same number of times per call whatever B is."""
    return pack_results(full_analysis_device(mols, *sizes, cfg))


def static_sizes(
    max_diameter: float, cfg: AnalysisConfig
) -> tuple[int, int, int, int]:
    """Static sampling sizes from a molecule's max diameter: point counts
    exactly the reference's (the spiral layout depends on them), path
    step bounds padded to multiples of 8."""
    radius = max_diameter / 2.0
    n_win = rays.number_of_points(radius, cfg.adjust)
    n_avg = rays.number_of_points(max_diameter, cfg.adjust)
    l1 = int(radius // cfg.increment) + 2
    l2 = int(radius // cfg.increment2) + 2
    return n_win, n_avg, ((l1 + 7) // 8) * 8, ((l2 + 7) // 8) * 8


def batch_sizes(pin: float, largest: float, cfg: AnalysisConfig) -> tuple[int, int, int, int]:
    """Static sizes of a batch: the sampling counts from the pin (the
    diameter the batch is sampled at), the path lengths covering
    ``largest`` too (the largest member, or a bound on it), so that no
    member's rays are cut short under a smaller pin."""
    n_win, n_avg, l1, l2 = static_sizes(pin, cfg)
    _, _, l1_b, l2_b = static_sizes(largest, cfg)
    return n_win, n_avg, max(l1, l1_b), max(l2, l2_b)


def max_dim_host(elements: np.ndarray, coordinates: np.ndarray) -> float:
    """Maximum vdW-corrected diameter in host float64 numpy (row-chunked),
    used only to size the sampling statically."""
    vdw = tables.ELEMENT_VDW[tables.element_ids(elements)]
    c = np.asarray(coordinates, dtype=np.float64)
    best = 0.0
    chunk = 1024
    for lo in range(0, len(c), chunk):
        diff = c[lo : lo + chunk, None, :] - c[None, :, :]
        d = np.sqrt((diff * diff).sum(-1))
        d += vdw[lo : lo + chunk, None]
        d += vdw[None, :]
        best = max(best, float(d.max()))
    return best


