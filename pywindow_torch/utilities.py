"""The reference-compatible function API (counterpart of
``pywindow_tpu.utilities``; reference: utilities.py).

Code written against ``pywindow.utilities`` can switch imports.  The
helpers are host numpy, in float64, except :func:`max_dim`,
:func:`pore_diameter`, :func:`opt_pore_diameter`, :func:`find_windows`,
:func:`find_average_diameter` and :func:`window_analysis`, which run
the port's device operations on ``device`` (the card unless the caller
asks for the CPU, in the device's pipeline dtype: float32 on the card,
where the optimisers are the stable kernels in float64, float64 on the
CPU).  Hot loops should use ``Molecule.full_analysis`` or
:mod:`pywindow_torch.parallel.batch` instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pywindow_torch import tables
from pywindow_torch.config import DEFAULT_CONFIG, escalate, resolve_device
from pywindow_torch.io.forcefield import (  # noqa: F401 (public re-exports)
    decipher_atom_key,
    dlf_notation,
    opls_notation,
)
from pywindow_torch.io.outputs import to_list  # noqa: F401
from pywindow_torch.ops import geometry, rays
from pywindow_torch.ops.analysis import max_dim_host, optimise_pore_centre_res, static_sizes
from pywindow_torch.ops.cell import (  # noqa: F401
    cart_to_frac,
    create_supercell,
    frac_to_cart,
    lattice_array_to_unit_cell,
    unit_cell_to_lattice_array,
    volume_from_cell_parameters,
    volume_from_lattice_array,
)
from pywindow_torch.ops.encoding import encode, encode_batch
from pywindow_torch.ops.rebuild import discrete_molecules  # noqa: F401
from pywindow_torch.ops.windows import _window_refine
from pywindow_torch.ops.windows import find_windows as _find_windows


def distance(a, b) -> float:
    """Euclidean distance between two points (reference: utilities.py:80-93)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2)))


def unique(input_list):
    """First-occurrence unique list (reference: utilities.py:54-69)."""
    out = []
    for item in input_list:
        if item not in out:
            out.append(item)
    return out


def molecular_weight(elements) -> float:
    """Sum of atomic masses for *elements*, in g/mol (reference: utilities.py:472)."""
    return float(tables.ELEMENT_MASS[tables.element_ids(elements)].sum())


def center_of_coor(coordinates) -> np.ndarray:
    """Geometric centroid of *coordinates* (reference: utilities.py:443)."""
    c = np.asarray(coordinates, dtype=np.float64)
    return c.sum(axis=0) / len(c)


def center_of_mass(elements, coordinates) -> np.ndarray:
    """Mass-weighted centroid (reference: utilities.py:454)."""
    m = tables.ELEMENT_MASS[tables.element_ids(elements)]
    c = np.asarray(coordinates, dtype=np.float64)
    return (c * m[:, None]).sum(axis=0) / m.sum()


def shift_com(elements, coordinates, com_adjust=None) -> np.ndarray:
    """Translate so the COM becomes ``com_adjust`` (default origin)
    (reference: utilities.py:344-352)."""
    if com_adjust is None:
        com_adjust = np.zeros(3)
    com = center_of_mass(elements, coordinates)
    return np.asarray(coordinates, dtype=np.float64) - (com - com_adjust)


def normal_vector(origin, vectors) -> np.ndarray:
    """Normal of the plane through two vectors sharing an origin
    (reference: utilities.py:813-817)."""
    vectors = np.asarray(vectors, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    return np.cross(vectors[0] - origin, vectors[1] - origin)


def angle_between_vectors(x, y) -> float:
    """Unsigned angle (via |dot|, so in [0, pi/2]) between two vectors
    (reference: utilities.py:1088-1097)."""
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    cosv = abs(float(np.dot(x, y))) / (np.linalg.norm(x) * np.linalg.norm(y))
    return float(np.arccos(np.clip(cosv, -1.0, 1.0)))


# -- on the device ------------------------------------------------------------


def max_dim(elements, coordinates, device: torch.device | str | None = None) -> tuple[int, int, float]:
    """(atom_1, atom_2, maximum diameter) (reference: utilities.py:355-372)."""
    a1, a2, d = geometry.max_dim(encode(elements, coordinates, device=resolve_device(device)))
    return int(a1), int(a2), float(d)


def pore_diameter(
    elements, coordinates, com=None, device: torch.device | str | None = None
) -> tuple[float, int]:
    """(pore diameter, limiting atom) about ``com`` (default: the centre
    of mass) (reference: utilities.py:375-388)."""
    mol = encode(elements, coordinates, device=resolve_device(device))
    if com is not None:
        com = torch.as_tensor(np.asarray(com, dtype=np.float64), device=mol.coords.device)
        com = com.to(mol.coords.dtype)
    d, idx = geometry.pore_diameter(mol, com=com)
    return float(d), int(idx)


def opt_pore_diameter(
    elements, coordinates, bounds=None, com=None, device: torch.device | str | None = None
) -> tuple[float, int, np.ndarray]:
    """(diameter, atom, optimised centre) (reference: utilities.py:400-426):
    L-BFGS-B from ``com`` (default: the centre of mass) within ``bounds``
    (default: the box of the pore radius about it), at the full
    optimiser budget, through :func:`~pywindow_torch.ops.analysis.optimise_pore_centre_res`:
    on the card the ``lbfgsb_stable`` kernel in float64, on the CPU the
    classic driver."""
    device = resolve_device(device)
    if com is None:
        com = center_of_mass(elements, coordinates)
    com = np.asarray(com, dtype=np.float64)
    if bounds is None:
        pore_r = pore_diameter(elements, coordinates, com=com, device=device)[0] / 2.0
        lower, upper = com - pore_r, com + pore_r
    else:
        bounds = np.asarray(bounds, dtype=np.float64)
        lower, upper = bounds[:, 0], bounds[:, 1]
    mol = encode_batch([(elements, coordinates)], device=device)
    dtype = mol.coords.dtype
    start = tuple(
        torch.as_tensor(np.asarray(v)[None], device=device).to(dtype) for v in (com, lower, upper)
    )
    cfg = dataclasses.replace(DEFAULT_CONFIG, fast_budgets=False)
    x, _ = optimise_pore_centre_res(mol, cfg, start=start)
    d, idx = geometry.pore_diameter(mol, com=x)
    return float(d[0]), int(idx[0]), x[0].cpu().numpy()


def find_windows(
    elements, coordinates, processes=None, adjust=1.0, pore_opt=True, increment=1.0,
    device: torch.device | str | None = None,
):
    """(window diameters, window centres) or None (reference:
    utilities.py:1364-1553).  ``processes`` is accepted for API
    compatibility and ignored.  Re-runs with a doubled open-ray cap when
    the open rays overflow it, and at the full optimiser budgets when a
    fast budget stopped an optimiser, as the full analysis does."""
    del processes
    device = resolve_device(device)
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, adjust=float(adjust), pore_opt=bool(pore_opt), increment=float(increment)
    )
    mol = encode_batch([(elements, coordinates)], device=device)
    maxd = max_dim_host(np.asarray(elements), np.asarray(coordinates))
    n_win, _, l1, l2 = static_sizes(maxd, cfg)
    while True:
        pore_capped = torch.zeros(1, dtype=torch.bool, device=device)
        if cfg.pore_opt:
            centre, pore_capped = optimise_pore_centre_res(mol, cfg)
        else:
            centre = geometry.center_of_mass(mol)
        res = _find_windows(mol, n_win, l1, l2, cfg, pore_centre=centre)
        if bool(res.open_overflow[0]):
            cfg = escalate(cfg, "open_overflow")
            continue
        if bool((res.opt_capped | pore_capped)[0]) and (full := escalate(cfg, "budget")):
            cfg = full
            continue
        break
    if not bool(res.any_open[0]):
        return None
    valid = res.valid[0].cpu().numpy()
    return res.diameters[0].cpu().numpy()[valid], res.centers[0].cpu().numpy()[valid]


def find_average_diameter(
    elements, coordinates, adjust=1.0, processes=None, device: torch.device | str | None = None
) -> float:
    """Average outline diameter (reference: utilities.py:1586-1650), on
    the ``ray_exit`` kernel on the card."""
    del processes
    mol = encode_batch([(elements, coordinates)], device=resolve_device(device))
    maxd = max_dim_host(np.asarray(elements), np.asarray(coordinates))
    n = rays.number_of_points(maxd, adjust)
    centred = geometry.shift_to(mol, torch.zeros_like(mol.coords[:, 0]))
    return float(rays.average_diameter(centred, n, geometry.max_dim(centred)[2])[0])


# -- shape (host numpy) ---------------------------------------------------------


def get_gyration_tensor(elements, coordinates) -> np.ndarray:
    """Centre-of-mass-corrected gyration tensor / N (reference:
    utilities.py:461-495)."""
    x = np.asarray(coordinates, dtype=np.float64) - center_of_mass(elements, coordinates)
    return x.T @ x / len(x)


def get_inertia_tensor(elements, coordinates) -> np.ndarray:
    """Inertia tensor / N with the reference's quirks (division by the
    atom count, no centre-of-mass correction; utilities.py:498-529) but
    not its broadcasting bug (see
    :func:`pywindow_torch.ops.geometry.inertia_tensor`)."""
    c = np.asarray(coordinates, dtype=np.float64)
    m = tables.ELEMENT_MASS[tables.element_ids(elements)]
    r2 = (c * c).sum(axis=1)
    t = (m * r2).sum() * np.eye(3) - (c * m[:, None]).T @ c
    return t / len(c)


def _sorted_inertia_eigenvalues(elements, coordinates) -> np.ndarray:
    return np.linalg.eigvalsh(get_inertia_tensor(elements, coordinates))[::-1]


def calc_asphericity(elements, coordinates) -> float:
    """reference: utilities.py:626-632."""
    e = _sorted_inertia_eigenvalues(elements, coordinates)
    return float(e[0] - (e[1] + e[2]) / 2)


def calc_acylidricity(elements, coordinates) -> float:
    """reference: utilities.py:635-641 (reference spelling kept)."""
    e = _sorted_inertia_eigenvalues(elements, coordinates)
    return float(e[1] - e[2])


def calc_relative_shape_anisotropy(elements, coordinates) -> float:
    """reference: utilities.py:644-650."""
    e = _sorted_inertia_eigenvalues(elements, coordinates)
    pair = e[0] * e[1] + e[0] * e[2] + e[1] * e[2]
    return float(1 - 3 * pair / e.sum() ** 2)


def principal_axes(elements, coordinates) -> np.ndarray:
    """Row eigenvectors of the inertia tensor
    (reference: utilities.py:532-536)."""
    return np.linalg.eig(get_inertia_tensor(elements, coordinates))[1].T


def normalize_vector(vector) -> np.ndarray:
    """Normalised and rounded to 4 decimals (reference quirk,
    utilities.py:539-555)."""
    v = np.divide(vector, np.linalg.norm(vector))
    return np.round(v, decimals=4)


def rotation_matrix_arbitrary_axis(angle: float, axis) -> np.ndarray:
    """Rotation by ``angle`` radians about ``axis``
    (reference: utilities.py:558-593)."""
    axis = normalize_vector(axis)
    a = np.cos(angle / 2)
    b, c, d = axis * np.sin(angle / 2)
    return np.array(
        [
            [
                a * a + b * b - c * c - d * d,
                2 * (b * c - a * d),
                2 * (b * d + a * c),
            ],
            [
                2 * (b * c + a * d),
                a * a + c * c - b * b - d * d,
                2 * (c * d - a * b),
            ],
            [
                2 * (b * d - a * c),
                2 * (c * d + a * b),
                a * a + d * d - b * b - c * c,
            ],
        ]
    )


def align_principal_ax(elements, coordinates):
    """Iteratively rotate so the principal axes align with x/y/z.

    Three sequential axis alignments as in the reference
    (utilities.py:596-623), with two deliberate fixes: the axes are
    recomputed from the *rotated* coordinates each iteration (the
    reference kept using the original frame, so its later rotations
    aligned stale axes), and the inertia tensor is the corrected one
    (see :func:`get_inertia_tensor`).  Returns
    (rotated_coordinates, [rotation matrices]).
    """
    coor = np.array(coordinates, dtype=np.float64, copy=True)
    rotations = []
    for axis_idx, target in zip(
        (2, 1, 0), ([1, 0, 0], [0, 1, 0], [0, 0, 1])
    ):
        p_axes = principal_axes(elements, coor)
        r_vec = np.cross(p_axes[axis_idx], np.array(target, dtype=float))
        sin = np.linalg.norm(r_vec)
        cos = np.dot(p_axes[axis_idx], np.array(target, dtype=float))
        ang = np.arctan2(sin, cos)
        r_mat = rotation_matrix_arbitrary_axis(ang, r_vec)
        rotations.append(r_mat)
        coor = coor @ r_mat.T
    return coor, rotations


def compose_atom_list(*args):
    """(elements, [atom_ids], coordinates) arrays -> nested atom list.

    Kept for reference compatibility (reference: utilities.py:151-220);
    the pipeline itself works on arrays, not atom lists.
    Coordinates are rounded to 8 decimals, as in the reference.
    """
    if len(args) == 2:
        elements, coordinates = args
        return [
            [str(e), *(round(float(x), 8) for x in xyz)]
            for e, xyz in zip(elements, coordinates)
        ]
    if len(args) == 3:
        elements, atom_ids, coordinates = args
        return [
            [str(e), str(a), *(round(float(x), 8) for x in xyz)]
            for e, a, xyz in zip(elements, atom_ids, coordinates)
        ]
    msg = "compose_atom_list() accepts 2 or 3 arguments"
    raise TypeError(msg)


def decompose_atom_list(atom_list):
    """Inverse of :func:`compose_atom_list`
    (reference: utilities.py:223-264)."""
    width = len(atom_list[0]) if atom_list else 0
    if width == 4:
        elements = np.array([row[0] for row in atom_list])
        coordinates = np.array([row[1:4] for row in atom_list], dtype=float)
        return elements, coordinates
    if width == 5:
        elements = np.array([row[0] for row in atom_list])
        atom_ids = np.array([row[1] for row in atom_list])
        coordinates = np.array([row[2:5] for row in atom_list], dtype=float)
        return elements, atom_ids, coordinates
    msg = "decompose_atom_list() needs rows of 4 or 5 items"
    raise TypeError(msg)


def circumcircle_window(coordinates, atom_set):
    """Window radius/centre from a triad of carbons (Holden et al.).

    The circumcircle of the three atoms minus the carbon vdW radius
    (1.70 A) — reference: utilities.py:1653-1676 (dead code there; kept
    here as a working utility).
    """
    coordinates = np.asarray(coordinates, dtype=np.float64)
    pa, pb, pc = (coordinates[int(i)] for i in atom_set[:3])
    a = np.linalg.norm(pc - pb)
    b = np.linalg.norm(pc - pa)
    c = np.linalg.norm(pb - pa)
    s = (a + b + c) / 2.0
    radius = a * b * c / (
        4.0 * np.sqrt(s * (s - a) * (s - b) * (s - c))
    ) - 1.70
    b1 = a * a * (b * b + c * c - a * a)
    b2 = b * b * (a * a + c * c - b * b)
    b3 = c * c * (a * a + b * b - c * c)
    centre = np.column_stack((pa, pb, pc)) @ np.array([b1, b2, b3])
    centre = centre / (b1 + b2 + b3)
    return float(radius), centre


def circumcircle(coordinates, atom_sets):
    """Circumcircle diameters/centres for many carbon triads
    (reference: utilities.py:1679-1691)."""
    diameters, centres = [], []
    for atom_set in atom_sets:
        r, com = circumcircle_window(coordinates, atom_set)
        diameters.append(r * 2.0)
        centres.append(com)
    return diameters, centres


def is_number(value: str) -> bool:
    """True if the string converts to a float
    (reference: utilities.py:45-51)."""
    try:
        float(value)
    except (ValueError, TypeError):
        return False
    return True


def sphere_volume(radius: float) -> float:
    """Volume of a sphere of *radius*
    (reference: utilities.py:618)."""
    return float(4.0 / 3.0 * np.pi * radius**3)


#: the typed property paths the comparator understands
#: (reference: utilities.py:1699-1715).
POSSIBLE_PROPERTIES = {
    "centre_of_mass": "array",
    "maximum_diameter.atom_1": "int",
    "maximum_diameter.atom_2": "int",
    "maximum_diameter.diameter": "float",
    "no_of_atoms": "int",
    "pore_diameter.atom": "int",
    "pore_diameter.diameter": "float",
    "pore_diameter_opt.atom_1": "int",
    "pore_diameter_opt.centre_of_mass": "array",
    "pore_diameter_opt.diameter": "float",
    "pore_volume": "float",
    "pore_volume_opt": "float",
    "windows.centre_of_mass": "array",
    "windows.diameters": "array",
    "average_diameter": "float",
}


def compare_properties_dict(
    dict1: dict, dict2: dict, rtol: float = 1e-05, atol: float = 1e-08
) -> tuple[bool, str]:
    """Typed comparison of two properties dictionaries.

    Returns ``(True, "none")`` on agreement or ``(False, prop)`` naming
    the first disagreeing property (reference: utilities.py:1694-1754).
    Tolerances are configurable (the reference hard-codes numpy
    defaults); pass e.g. ``atol=0.01`` for the cross-implementation
    accuracy contract.
    """
    for prop, method in POSSIBLE_PROPERTIES.items():
        path = prop.split(".")
        head = path[0]
        in1, in2 = head in dict1, head in dict2
        if not in1 and not in2:
            continue
        if in1 != in2:
            return (False, prop)
        item1, item2 = dict1[head], dict2[head]
        if len(path) == 2:
            # nested keys compare only when both sides carry them (the
            # reference raised KeyError on partial nests); this allows
            # partial expected dicts in validation scripts.
            sub1 = isinstance(item1, dict) and path[1] in item1
            sub2 = isinstance(item2, dict) and path[1] in item2
            if not (sub1 and sub2):
                continue
            item1 = item1[path[1]]
            item2 = item2[path[1]]
        if (item1 is None) != (item2 is None):
            return (False, prop)
        if item1 is None:
            continue
        if method == "array" and not np.allclose(
            item1, item2, rtol=rtol, atol=atol
        ):
            return (False, prop)
        if method == "float" and not np.isclose(
            item1, item2, rtol=rtol, atol=atol
        ):
            return (False, prop)
        if method == "int" and item1 != item2:
            return (False, prop)
    return (True, "none")


# ---------------------------------------------------------------------
# per-ray / per-window reference-surface functions
# (reference: utilities.py:391-397, 434-458, 722-765, 820-1085,
#  1100-1188, 1191-1361, 1556-1583)
# ---------------------------------------------------------------------


def correct_pore_diameter(com, *params, device: torch.device | str | None = None):
    """Negative pore diameter (the pore-optimisation objective;
    reference: utilities.py:391-397), on ``device`` (the card by
    default)."""
    elements, coordinates = params
    return -pore_diameter(elements, coordinates, com=com, device=device)[0]


def asphericity(shap) -> float:
    """Asphericity from sorted tensor eigenvalues
    (reference: utilities.py:434-435)."""
    shap = np.asarray(shap, dtype=np.float64)
    return float(shap[0] - (shap[1] + shap[2]) / 2)


def acylidricity(shap) -> float:
    """Acylindricity from sorted tensor eigenvalues
    (reference: utilities.py:438-439)."""
    shap = np.asarray(shap, dtype=np.float64)
    return float(shap[1] - shap[2])


def relative_shape_anisotropy(shap) -> float:
    """Relative shape anisotropy from sorted tensor eigenvalues
    (reference: utilities.py:442-446)."""
    shap = np.asarray(shap, dtype=np.float64)
    return float(
        1
        - 3
        * (
            (shap[0] * shap[1] + shap[0] * shap[2] + shap[1] * shap[2])
            / (np.sum(shap)) ** 2
        )
    )


def get_tensor_eigenvalues(arr, sort: bool = False) -> np.ndarray:
    """Eigenvalues of a tensor, optionally sorted descending
    (reference: utilities.py:449-458)."""
    vals = np.linalg.eigvals(np.asarray(arr, dtype=np.float64))
    if sort:
        return np.array(sorted(vals, reverse=True))
    return vals


def fractional_from_cartesian(coordinate, lattice_array) -> np.ndarray:
    """One cartesian coordinate -> fractional
    (reference: utilities.py:722-729)."""
    inv = np.linalg.inv(np.asarray(lattice_array, dtype=np.float64))
    return (inv @ np.asarray(coordinate, dtype=np.float64).reshape(-1, 1)).reshape(
        1, 3
    )


def cartisian_from_fractional(coordinate, lattice_array) -> np.ndarray:
    """One fractional coordinate -> cartesian (the reference's spelling;
    reference: utilities.py:732-739)."""
    lat = np.asarray(lattice_array, dtype=np.float64)
    return (lat @ np.asarray(coordinate, dtype=np.float64).reshape(-1, 1)).reshape(
        1, 3
    )


def cart2frac_all(coordinates, lattice_array) -> np.ndarray:
    """All cartesian coordinates -> fractional
    (reference: utilities.py:742-752; vectorised here)."""
    return cart_to_frac(
        np.asarray(coordinates, dtype=np.float64),
        np.asarray(lattice_array, dtype=np.float64),
    )


def frac2cart_all(frac_coordinates, lattice_array) -> np.ndarray:
    """All fractional coordinates -> cartesian
    (reference: utilities.py:755-765; vectorised here)."""
    return frac_to_cart(
        np.asarray(frac_coordinates, dtype=np.float64),
        np.asarray(lattice_array, dtype=np.float64),
    )


def vector_analysis(vector, coordinates, elements_vdw, increment=1.0):
    """Walk a sampling vector in ``increment`` steps; if every step has
    positive clearance return ``[dist, width, *narrow, *vector]``, else
    None (reference: utilities.py:1100-1129)."""
    vector = np.asarray(vector, dtype=np.float64)
    coordinates = np.asarray(coordinates, dtype=np.float64)
    elements_vdw = np.asarray(elements_vdw, dtype=np.float64).reshape(-1)
    chunks = int(np.linalg.norm(vector) // increment)
    if chunks == 0:
        return None
    chunk = vector / chunks
    pathway = np.array([chunk * i for i in range(chunks + 1)])
    dists = np.sqrt(
        ((coordinates[None, :, :] - pathway[:, None, :]) ** 2).sum(-1)
    )
    analysed = np.amin(dists - elements_vdw[None, :], axis=1)
    if np.all(analysed > 0):
        pos = int(np.argmin(analysed))
        dist = float(np.linalg.norm(chunk * pos))
        return np.array([dist, analysed[pos] * 2, *(chunk * pos), *vector])
    return None


def _front_intersections(vector, coordinates, elements_vdw):
    """Analytic ray/vdW-sphere intersections; yields (|p1|, p1) for
    spheres whose nearer crossing is in front (shared by the
    pre-analysis and the reversed exit scan)."""
    vector = np.asarray(vector, dtype=np.float64)
    coordinates = np.asarray(coordinates, dtype=np.float64)
    elements_vdw = np.asarray(elements_vdw, dtype=np.float64).reshape(-1)
    norm_vec = vector / np.linalg.norm(vector)
    origin = coordinates.mean(axis=0)
    length = coordinates - origin
    t_ca = length @ norm_vec
    d2 = np.einsum("ij,ij->i", length, length) - t_ca**2
    under = elements_vdw**2 - d2
    out = []
    for pos in np.flatnonzero(under > 0):
        t_hc = np.sqrt(under[pos])
        p_0 = origin + (t_ca[pos] - t_hc) * norm_vec
        p_1 = origin + (t_ca[pos] + t_hc) * norm_vec
        if np.linalg.norm(p_0) < np.linalg.norm(p_1):
            out.append((float(np.linalg.norm(p_1)), p_1))
    return out


def vector_preanalysis(vector, coordinates, elements_vdw, increment=1.0):
    """Reject rays blocked by a front sphere crossing; open rays proceed
    to :func:`vector_analysis` (reference: utilities.py:1132-1161)."""
    if _front_intersections(vector, coordinates, elements_vdw):
        return None
    return vector_analysis(vector, coordinates, elements_vdw, increment)


def vector_analysis_reversed(vector, coordinates, elements_vdw):
    """Farthest front vdW-sphere exit along the ray, for the average
    diameter (reference: utilities.py:1556-1583)."""
    hits = _front_intersections(vector, coordinates, elements_vdw)
    if not hits:
        return None
    dist, point = max(hits, key=lambda h: h[0])
    return [dist, point]


def optimise_xy(xy, *args, device: torch.device | str | None = None):
    """Window xy objective: negative pore diameter at (x, y, z) on
    ``device`` (the card by default) (reference: utilities.py:1164-1171)."""
    z, elements, coordinates = args
    com = np.array([xy[0], xy[1], z])
    return -pore_diameter(elements, coordinates, com=com, device=device)[0]


def optimise_z(z, *args, device: torch.device | str | None = None):
    """Window z objective: pore diameter at (x, y, z) on ``device`` (the
    card by default) (reference: utilities.py:1174-1188)."""
    x, y, elements, coordinates = args
    com = np.array([x, y, np.asarray(z).reshape(-1)[0]])
    return pore_diameter(elements, coordinates, com=com, device=device)[0]


def window_analysis(
    window,
    elements,
    coordinates,
    elements_vdw=None,
    increment2: float = 0.1,
    z_bounds=None,
    lb_z: bool = True,
    z_second_mini: bool = False,
    device: torch.device | str | None = None,
):
    """Refine one window cluster: its widest ray re-sampled at
    ``increment2`` (``path_sweep`` on the card), the octant rotation and
    the z / xy optimisation (``lbfgsb_stable`` and ``nm_xy`` on the
    card); returns ``(diameter, window_centre)`` or None (reference:
    utilities.py:1191-1361).  ``elements_vdw`` (per-atom radii) enters
    only the re-sampling, as in the reference (utilities.py:1221-1224
    against :1298-1336); ``coordinates`` must be pore-centred, the
    reference's calling convention.  Re-runs at the full optimiser
    budgets when a fast budget stopped an optimiser."""
    del z_bounds
    device = resolve_device(device)
    window = np.atleast_2d(np.asarray(window, dtype=np.float64))
    vector = window[window.argmax(axis=0)[1]][5:8]
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, increment2=float(increment2), lb_z=bool(lb_z),
        z_second_mini=bool(z_second_mini),
    )
    mol = encode_batch([(elements, coordinates)], device=device)
    mol_resample = mol
    if elements_vdw is not None:
        radii = np.asarray(elements_vdw, dtype=np.float64).reshape(-1)
        if len(radii) != len(np.asarray(elements)):
            msg = "elements_vdw must hold one radius per atom"
            raise ValueError(msg)
        vdw = torch.zeros_like(mol.vdw)
        vdw[0, : len(radii)] = torch.as_tensor(radii, device=device)
        mol_resample = mol._replace(vdw=vdw)
    l2 = int(np.linalg.norm(vector) // increment2) + 2
    l2 = ((l2 + 7) // 8) * 8
    v = torch.as_tensor(vector, device=device).to(mol.coords.dtype)[None, None, :]
    refined = rays.path_analysis(v, mol_resample, cfg.increment2, l2)
    if not bool(refined.ok[0, 0]):
        return None
    while True:
        diameter, centre, capped = _window_refine(mol, v, refined.dist, refined.ok, cfg)
        if bool(capped[0, 0]) and (full := escalate(cfg, "budget")):
            cfg = full
            continue
        break
    return float(diameter[0, 0]), centre[0, 0].cpu().numpy()
