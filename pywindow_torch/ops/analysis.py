"""Full single-molecule analysis: the pipeline behind
``Molecule.full_analysis`` (counterpart of ``pywindow_tpu.ops.analysis``;
reference: molecular.py:156-202).

``full_analysis_device`` computes every property of a batch of B
molecules (B, N) on their device, with no loop over frames: one
molecule is the B = 1 case.  :func:`analyze` derives the static sampling
sizes on the host, fetches the packed result in one transfer, re-runs
with escalated caps or budgets where the device flags it, and converts
the result into the reference's properties-dict schema;
:func:`to_properties_dicts_bulk` does the conversion for a whole batch.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from pywindow_torch import profiling, tables
from pywindow_torch.config import (
    DEFAULT_CONFIG,
    ESCALATION_MARKERS,
    OPT_DTYPE,
    AnalysisConfig,
    effective_budgets,
    escalate,
    pore_opt_mode,
    resolve_device,
)
from pywindow_torch.ops import rays
from pywindow_torch.ops.encoding import MolArrays, encode_batch
from pywindow_torch.ops.geometry import (
    center_of_mass,
    clearance_field,
    max_dim,
    max_dim_value,
    molecular_weight,
    pore_diameter,
    shift_to,
    sphere_volume,
)
from pywindow_torch.ops.lbfgsb import lbfgsb_minimize
from pywindow_torch.ops.lbfgsb_kernels import EMB_XYZ, lbfgsb_stable_flat
from pywindow_torch.ops.windows import WindowsResult, find_windows
from pywindow_torch.profiling import METRICS, stage

logger = logging.getLogger("pywindow_torch")


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

    Runs in :data:`~pywindow_torch.config.OPT_DTYPE`: the stable driver,
    the ``lbfgsb_stable`` kernel on the card, for a float32 pipeline;
    the plain FD driver for float64 (see
    :func:`~pywindow_torch.config.pore_opt_mode`).
    """
    opt_maxiter, _ = effective_budgets(cfg)
    stable = pore_opt_mode(mol.coords.dtype) == "stable"
    omol = mol.to(OPT_DTYPE)
    if start is None:
        com = center_of_mass(omol)
        pd0, _ = pore_diameter(omol, com=com)
        pore_r = (pd0 / 2.0)[:, None]
        x0, lower, upper = com, com - pore_r, com + pore_r
    else:
        x0, lower, upper = (t.to(OPT_DTYPE) for t in start)
    if stable:
        x, _, _, _, capped = lbfgsb_stable_flat(
            omol.coords, omol.vdw, torch.zeros_like(x0), x0, lower, upper,
            emb=EMB_XYZ, sign=-1.0, maxiter=opt_maxiter,
        )
    else:

        def f_neg(points):
            return -2.0 * clearance_field(points, omol)

        opt = lbfgsb_minimize(f_neg, x0, lower, upper, maxiter=opt_maxiter)
        x, capped = opt.x, opt.capped
    return x.to(mol.coords.dtype), capped


def optimise_pore_centre(mol: MolArrays, cfg: AnalysisConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """The optimised pore centres (B, 3) (see :func:`optimise_pore_centre_res`)."""
    return optimise_pore_centre_res(mol, cfg)[0]


def pore_diameter_opt(
    mol: MolArrays, cfg: AnalysisConfig = DEFAULT_CONFIG
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The optimised pore of each molecule (reference:
    utilities.py:400-426): ``(d, atom, centre, capped)``, the pore
    diameter and limiting atom at the centre of
    :func:`optimise_pore_centre_res` and its budget flag, each with the
    batch's leading axis."""
    centre, capped = optimise_pore_centre_res(mol, cfg)
    d, atom = pore_diameter(mol, com=centre)
    return d, atom, centre, capped


def full_analysis_device(
    mol: MolArrays,
    n_points_windows: int,
    n_points_avg: int,
    l1: int,
    l2: int,
    cfg: AnalysisConfig,
) -> FullAnalysis:
    """Every per-molecule property of the batch ``mol`` (B, N), computed
    on its device; each stage's host enqueue is a ``pipeline.<stage>``
    span."""
    with stage("pipeline.scalars"):
        mw = molecular_weight(mol)
        com = center_of_mass(mol)
        a1, a2, maxd = max_dim(mol)

    # average diameter on the COM-centred molecule, sampling radius =
    # the full max diameter (utilities.py:1586-1650)
    with stage("pipeline.average"):
        centred = shift_to(mol, torch.zeros_like(com))
        avg = rays.average_diameter(centred, n_points_avg, max_dim_value(centred))

    with stage("pipeline.pore"):
        pd, pd_atom = pore_diameter(mol, com=com)
        pv = sphere_volume(pd / 2.0)
    with stage("pipeline.pore_opt"):
        pod_centre, pore_capped = optimise_pore_centre_res(mol, cfg)
        pod, pod_atom = pore_diameter(mol, com=pod_centre)
        pov = sphere_volume(pod / 2.0)

    with stage("pipeline.windows"):
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
    res = full_analysis_device(mols, *sizes, cfg)
    with stage("pipeline.pack"):
        return pack_results(res)


def unpack_results(flat: np.ndarray, max_windows: int) -> FullAnalysis:
    """Host-side inverse of :func:`pack_results` for one row (numpy
    arrays)."""
    wnd = max_windows
    s = flat[:15]
    off = packed_size(0)
    wins = WindowsResult(
        diameters=flat[off : off + wnd],
        centers=flat[off + 3 * wnd : off + 6 * wnd].reshape(wnd, 3),
        valid=flat[off + wnd : off + 2 * wnd] > 0.5,
        any_open=np.bool_(s[11] > 0.5),
        n_clusters=np.int32(round(float(s[12]))),
        refine_failed=flat[off + 2 * wnd : off + 3 * wnd] > 0.5,
        open_overflow=np.bool_(s[13] > 0.5),
        opt_capped=np.bool_(s[14] > 0.5),
    )
    return FullAnalysis(
        molecular_weight=s[0],
        centre_of_mass=flat[15:18],
        maxd_atom_1=np.int64(round(float(s[7]))),
        maxd_atom_2=np.int64(round(float(s[8]))),
        maximum_diameter=s[1],
        average_diameter=s[2],
        pore_diameter=s[3],
        pore_atom=np.int64(round(float(s[9]))),
        pore_volume=s[4],
        pore_opt_diameter=s[5],
        pore_opt_atom=np.int64(round(float(s[10]))),
        pore_opt_centre=flat[18:21],
        pore_opt_volume=s[6],
        windows=wins,
    )


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


def analyze(
    elements: np.ndarray,
    coordinates: np.ndarray,
    cfg: AnalysisConfig = DEFAULT_CONFIG,
    pad_to: int | None = None,
    device: torch.device | str | None = None,
) -> dict:
    """Host entry: full analysis of one molecule on ``device`` (the card
    unless the caller asks for the CPU) -> reference-schema properties
    dict.  The molecule runs as a batch of one.

    Re-runs with a doubled compaction fraction when the open rays
    overflowed the cap, at the full optimiser budgets when a fast budget
    stopped an optimiser, and with a doubled window cap when the
    clusters filled every slot (up to MAX_WINDOWS_CEILING), by
    :func:`~pywindow_torch.config.escalate`; each re-run
    is an ``analysis_rerun`` span and counts as
    ``analysis_reruns.<reason>``.
    """
    device = resolve_device(device)
    with stage("encode"):
        mol = encode_batch([(elements, coordinates)], pad_to=pad_to, device=device)
    with stage("static_sizes"):
        maxd = max_dim_host(np.asarray(elements), np.asarray(coordinates))
        sizes = static_sizes(maxd, cfg)
    res, props = _analysis_pass(mol, sizes, cfg)
    while True:
        hit = [reason for reason, marker in ESCALATION_MARKERS.items() if props.pop(marker, False)]
        step = next(((r, nxt) for r in hit if (nxt := escalate(cfg, r)) is not None), None)
        if step is None:
            break
        reason, cfg = step
        METRICS.count(f"analysis_reruns.{reason}")
        with stage("analysis_rerun", reason=reason):
            res, props = _analysis_pass(mol, sizes, cfg)
    if int(res.windows.n_clusters) >= cfg.max_windows:
        logger.warning(
            "window clusters reached max_windows=%d; raise "
            "AnalysisConfig.max_windows if this system may have more",
            cfg.max_windows,
        )
    if profiling.enabled():
        METRICS.count("molecules_analysed")
        METRICS.count("windows_found", int(np.sum(res.windows.valid)))
        METRICS.count(
            "window_refines_failed", int(np.sum(res.windows.refine_failed))
        )
    return props


def _analysis_pass(
    mol: MolArrays, sizes: tuple[int, int, int, int], cfg: AnalysisConfig
) -> tuple[FullAnalysis, dict]:
    """One pass of :func:`analyze`: the device pipeline enqueued, its
    packed row fetched, the properties dict (markers in)."""
    with stage("analysis_enqueue"):
        flat = run_pipeline(mol, sizes, cfg)
    with stage("analysis_fetch"):
        row = flat[0].cpu().numpy()
    with stage("analysis_dict"):
        res = unpack_results(row, cfg.max_windows)
        props = to_properties_dict(res)
    return res, props


_WARN_FAILED = (
    "one of the analysed windows has returned as None (refinement failed); see manual"
)
_WARN_NEGATIVE = (
    "one of the analysed windows has a vdW-corrected diameter smaller than 0; see manual"
)


def to_properties_dict(res: FullAnalysis) -> dict:
    """Results in the reference properties schema (keys as produced by
    molecular.py:215-352), plus the ``_open_cap_overflow``,
    ``_opt_budget_exceeded`` and ``_window_cap_saturated`` markers that
    :func:`analyze` pops to decide a re-run."""
    wins = res.windows
    if not bool(wins.any_open):
        windows = {"diameters": None, "centre_of_mass": None}
    else:
        valid = np.asarray(wins.valid)
        windows = {
            "diameters": np.asarray(wins.diameters)[valid],
            "centre_of_mass": np.asarray(wins.centers)[valid],
        }
        if bool(np.any(np.asarray(wins.refine_failed))):
            logger.warning(_WARN_FAILED)
        if windows["diameters"].size and np.any(windows["diameters"] < 0):
            logger.warning(_WARN_NEGATIVE)
    out = {
        "centre_of_mass": np.asarray(res.centre_of_mass),
        "maximum_diameter": {
            "diameter": float(res.maximum_diameter),
            "atom_1": int(res.maxd_atom_1),
            "atom_2": int(res.maxd_atom_2),
        },
        "average_diameter": float(res.average_diameter),
        "pore_diameter": {
            "diameter": float(res.pore_diameter),
            "atom": int(res.pore_atom),
        },
        "pore_volume": float(res.pore_volume),
        "pore_diameter_opt": {
            "diameter": float(res.pore_opt_diameter),
            "atom_1": int(res.pore_opt_atom),
            "centre_of_mass": np.asarray(res.pore_opt_centre),
        },
        "pore_volume_opt": float(res.pore_opt_volume),
        "windows": windows,
        "molecular_weight": float(res.molecular_weight),
    }
    if int(wins.n_clusters) >= len(np.asarray(wins.diameters)):
        out["_window_cap_saturated"] = True
    if bool(wins.open_overflow):
        out["_open_cap_overflow"] = True
    if bool(np.asarray(wins.opt_capped)):
        out["_opt_budget_exceeded"] = True
    return out


def to_properties_dicts_bulk(flat: np.ndarray, max_windows: int) -> list[dict]:
    """``to_properties_dict(unpack_results(row))`` for every row of a
    (B, packed) float32 or float64 host block, through the native
    converter ``_native/fastprops.cpp`` (counterpart of
    ``pywindow_tpu.ops.analysis.to_properties_dicts_bulk``): the same
    dicts, dtypes and window warnings as
    :func:`to_properties_dicts_bulk_plain`, its plain version.  The
    dicts' centre arrays are views into ``flat``, so the caller passes
    a block that nothing writes afterwards.  Raises
    :class:`~pywindow_torch.native.NativeBuildError` when the converter
    cannot be built."""
    from pywindow_torch import native

    out, warn_failed, warn_negative = native.props_dicts(flat, max_windows)
    for _ in warn_failed:
        logger.warning(_WARN_FAILED)
    for _ in warn_negative:
        logger.warning(_WARN_NEGATIVE)
    return out


def to_properties_dicts_bulk_plain(flat: np.ndarray, max_windows: int) -> list[dict]:
    """The plain version of :func:`to_properties_dicts_bulk`:
    ``to_properties_dict(unpack_results(row))`` for every row, in
    Python, with the scalar columns converted once."""
    w = max_windows
    off = packed_size(0)
    b = flat.shape[0]
    any_open = flat[:, 11] > 0.5
    diam = np.ascontiguousarray(flat[:, off : off + w])
    valid = flat[:, off + w : off + 2 * w] > 0.5
    fail_any = (flat[:, off + 2 * w : off + 3 * w] > 0.5).any(axis=1)
    neg_any = ((diam < 0) & valid).any(axis=1)
    cent = np.ascontiguousarray(flat[:, off + 3 * w : off + 6 * w]).reshape(b, w, 3)
    com = np.ascontiguousarray(flat[:, 15:18])
    com_opt = np.ascontiguousarray(flat[:, 18:21])
    cap_sat = np.rint(flat[:, 12]).astype(np.int64) >= w
    overflow = flat[:, 13] > 0.5
    budget = flat[:, 14] > 0.5
    rows = flat[:, :15].tolist()
    out: list[dict] = []
    for i in range(b):
        r = rows[i]
        if not any_open[i]:
            windows: dict = {"diameters": None, "centre_of_mass": None}
        else:
            v = valid[i]
            windows = {"diameters": diam[i, v], "centre_of_mass": cent[i, v]}
            if fail_any[i]:
                logger.warning(_WARN_FAILED)
            if neg_any[i]:
                logger.warning(_WARN_NEGATIVE)
        props = {
            "centre_of_mass": com[i],
            "maximum_diameter": {
                "diameter": r[1],
                "atom_1": int(round(r[7])),
                "atom_2": int(round(r[8])),
            },
            "average_diameter": r[2],
            "pore_diameter": {"diameter": r[3], "atom": int(round(r[9]))},
            "pore_volume": r[4],
            "pore_diameter_opt": {
                "diameter": r[5],
                "atom_1": int(round(r[10])),
                "centre_of_mass": com_opt[i],
            },
            "pore_volume_opt": r[6],
            "windows": windows,
            "molecular_weight": r[0],
        }
        if cap_sat[i]:
            props["_window_cap_saturated"] = True
        if overflow[i]:
            props["_open_cap_overflow"] = True
        if budget[i]:
            props["_opt_budget_exceeded"] = True
        out.append(props)
    return out


def max_dim_bound(elements: np.ndarray, coordinates: np.ndarray) -> float:
    """Cheap O(N) upper bound on the vdW-corrected maximum diameter
    (bounding-box diagonal + two max vdW radii), used to size the ray
    paths of a whole batch."""
    ids = tables.element_ids(elements)
    c = np.asarray(coordinates, dtype=np.float64)
    diag = float(np.linalg.norm(c.max(axis=0) - c.min(axis=0)))
    return diag + 2.0 * float(tables.ELEMENT_VDW[ids].max())
