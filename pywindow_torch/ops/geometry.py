"""Core geometry: the vdW clearance field and friends.

``clearance(p) = min_i(||x_i - p|| - vdw_i)`` over valid atoms underlies
maximum diameter, pore diameter, the ray sweeps and both optimisers
(counterpart of ``pywindow_tpu.ops.geometry``).  Every function takes
padded, masked :class:`~pywindow_torch.ops.encoding.MolArrays` and
broadcasts over leading batch dims.  Distances are written per
coordinate (``dx*dx + dy*dy + dz*dz``), the same operation order the
CUDA kernels use, so kernel and plain versions round alike.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import torch

from pywindow_torch.ops.encoding import MolArrays

BIG = 1.0e30


def sq_norm3(v: torch.Tensor) -> torch.Tensor:
    """``v0*v0 + v1*v1 + v2*v2`` over the trailing axis of size 3."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def center_of_mass(mol: MolArrays) -> torch.Tensor:
    """Mass-weighted centre (reference: utilities.py:127-148)."""
    w = torch.where(mol.mask, mol.mass, 0.0)
    return (mol.coords * w[..., None]).sum(-2) / w.sum(-1, keepdim=True)


def center_of_coor(mol: MolArrays) -> torch.Tensor:
    """Unweighted coordinate mean (reference: utilities.py:110-124)."""
    w = mol.mask.to(mol.coords.dtype)
    return (mol.coords * w[..., None]).sum(-2) / w.sum(-1, keepdim=True)


def molecular_weight(mol: MolArrays) -> torch.Tensor:
    """Sum of atomic masses (reference: utilities.py:96-107)."""
    return torch.where(mol.mask, mol.mass, 0.0).sum(-1)


def shift_to(mol: MolArrays, target_com: torch.Tensor) -> MolArrays:
    """Translate so the centre of mass lands on ``target_com``
    (reference ``shift_com``, utilities.py:344-352)."""
    shift = center_of_mass(mol) - target_com
    return mol._replace(
        coords=torch.where(
            mol.mask[..., None], mol.coords - shift[..., None, :], mol.coords
        )
    )


def pairwise_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances between ``a`` (..., P, 3) and ``b`` (..., N, 3),
    in the difference form (accuracy over the Gram form's speed)."""
    return torch.sqrt(sq_norm3(a[..., :, None, :] - b[..., None, :, :]))


def clearance_field(points: torch.Tensor, mol: MolArrays) -> torch.Tensor:
    """vdW clearance ``min_i(||x_i - p|| - vdw_i)`` of each probe point:
    (..., P, 3) -> (..., P).  Padded atoms cannot win (masked to BIG)."""
    d = pairwise_distances(points, mol.coords) - mol.vdw[..., None, :]
    return torch.where(mol.mask[..., None, :], d, BIG).amin(-1)


def clearance_diff(
    x: torch.Tensor, disp: torch.Tensor, mol: MolArrays
) -> torch.Tensor:
    """Cancellation-free ``clearance(x + s_k) - clearance(x)``.

    The per-atom distance change is taken symbolically as
    ``(2 s.(x-a) + |s|^2) / (|p-a| + |x-a|)`` and the difference of
    minima as ``min_i((c_i - m0) + delta_i)``, so the result keeps full
    relative precision even for ``|s| ~ 1e-8`` in float32
    (geometry.py:81-135 of the JAX package has the derivation).
    x: (..., 3); disp: (..., K, 3) -> (..., K).
    """
    dxv = x[..., None, :] - mol.coords  # (..., N, 3)
    db2 = sq_norm3(dxv)
    db = torch.sqrt(db2)
    cb = torch.where(mol.mask, db - mol.vdw, BIG)
    m0 = cb.amin(-1)
    base = cb - m0[..., None]

    s2 = sq_norm3(disp)  # (..., K)
    g = (
        disp[..., :, 0, None] * dxv[..., None, :, 0]
        + disp[..., :, 1, None] * dxv[..., None, :, 1]
        + disp[..., :, 2, None] * dxv[..., None, :, 2]
    )  # (..., K, N)
    num = 2.0 * g + s2[..., :, None]
    # |p-a|^2 = db2 + num >= 0 exactly; clamp rounding dips
    dp = torch.sqrt(torch.clamp_min(db2[..., None, :] + num, 0.0))
    den = db[..., None, :] + dp
    delta = num / torch.where(den == 0.0, 1.0, den)
    q = torch.where(mol.mask[..., None, :], base[..., None, :] + delta, BIG)
    return q.amin(-1)


def pore_stable_probe(
    mol: MolArrays,
    sign: float = -1.0,
    origin: torch.Tensor | None = None,
    embed: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> Callable:
    """Symbolic-difference probe of the pore objective ``sign * 2 *
    clearance`` (``-2 * clearance`` by default) for
    :func:`pywindow_torch.ops.lbfgsb.lbfgsb_minimize_stable`.

    Returns ``probe(x, disp, h) -> (delta_f, grad)`` over a batch
    (x, disp, h (B, d) -> (B,), (B, d)): ``delta_f = f(x + disp) -
    f(x)`` by :func:`clearance_diff` (cancellation-free for any
    ``|disp|``) and the 2-point FD gradient at ``x + disp`` whose
    numerators are symbolic ``h``-displacements, so scipy's ``h = 1e-8``
    step works in float32 (geometry.py:138-158 of the JAX package).
    The probed point is ``x`` (d = 3), or ``origin + embed(x)`` for a
    lower-dimensional search (``embed``: (..., d) -> (..., 3)), as the
    ``lbfgsb_stable`` kernel's plain version probes the window z.
    """
    sign2 = sign * 2.0
    if embed is None:
        def embed(s):
            return s

    def point3(x):
        return embed(x) if origin is None else origin + embed(x)

    def probe(x, disp, h):
        delta = clearance_diff(point3(x), embed(disp)[:, None, :], mol)[:, 0]
        steps = embed(torch.diag_embed(h))  # (B, d, 3)
        dprobe = clearance_diff(point3(x + disp), steps, mol)
        return sign2 * delta, (sign2 * dprobe) / h

    return probe


def clearance_and_argmin(
    points: torch.Tensor, mol: MolArrays
) -> tuple[torch.Tensor, torch.Tensor]:
    """Clearance plus the index of the limiting atom (first on ties)."""
    d = pairwise_distances(points, mol.coords) - mol.vdw[..., None, :]
    d = torch.where(mol.mask[..., None, :], d, BIG)
    return d.amin(-1), d.argmin(-1)


def max_dim(mol: MolArrays) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Maximum vdW-corrected diameter and the two atoms realising it:
    the upper-triangle (diagonal included) argmax of ``dist(i,j) + vdw_i
    + vdw_j``, row-major first maximum, as ``np.triu`` + ``argmax`` in
    the reference (utilities.py:355-372).  The plain version on the CPU,
    the ``max_dim`` kernel on the card
    (:func:`pywindow_torch.ops.pair_kernels.max_dim`)."""
    from pywindow_torch.ops import pair_kernels  # it imports this module

    return pair_kernels.max_dim(mol)


def max_dim_value(mol: MolArrays) -> torch.Tensor:
    """Maximum vdW-corrected diameter, value only, the maximum over the
    full symmetric matrix (:func:`pywindow_torch.ops.pair_kernels.max_dim_value`)."""
    from pywindow_torch.ops import pair_kernels

    return pair_kernels.max_dim_value(mol)


def pore_diameter(
    mol: MolArrays, com: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Intrinsic pore diameter ``2 * clearance(com)`` and limiting atom
    (reference: utilities.py:375-388)."""
    if com is None:
        com = center_of_mass(mol)
    c, idx = clearance_and_argmin(com[..., None, :], mol)
    return 2.0 * c[..., 0], idx[..., 0]


def sphere_volume(radius: torch.Tensor) -> torch.Tensor:
    """4/3 pi r^3 (reference: utilities.py:429-431)."""
    return 4.0 / 3.0 * math.pi * radius**3


# -- shape descriptors (reference: utilities.py:434-650) ---------------------


def gyration_tensor(mol: MolArrays) -> torch.Tensor:
    """Centre-of-mass-corrected gyration tensor / N (reference:
    utilities.py:461-495): (..., 3, 3)."""
    com = center_of_mass(mol)
    x = torch.where(mol.mask[..., None], mol.coords - com[..., None, :], 0.0)
    n = mol.mask.sum(-1).to(x.dtype)
    return torch.einsum("...ni,...nj->...ij", x, x) / n[..., None, None]


def inertia_tensor(mol: MolArrays) -> torch.Tensor:
    """Mass-weighted inertia tensor / N: (..., 3, 3).

    As in the JAX package (geometry.py:249-275): the reference's
    division by the atom count and its missing centre-of-mass
    correction are kept (utilities.py:498-529); its broadcasting bug,
    which summed every mass against every coordinate, is not.
    """
    x = torch.where(mol.mask[..., None], mol.coords, 0.0)
    m = torch.where(mol.mask, mol.mass, 0.0)
    r2 = sq_norm3(x)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    t = (m * r2).sum(-1)[..., None, None] * eye - torch.einsum("...n,...ni,...nj->...ij", m, x, x)
    return t / mol.mask.sum(-1).to(x.dtype)[..., None, None]


def sorted_eigenvalues(tensor: torch.Tensor) -> torch.Tensor:
    """Descending eigenvalues of symmetric 3 x 3 tensors (..., 3)."""
    return torch.linalg.eigvalsh(tensor).flip(-1)


def asphericity(eigvals_desc: torch.Tensor) -> torch.Tensor:
    """Asphericity from descending eigenvalues (reference: utilities.py:626)."""
    return eigvals_desc[..., 0] - 0.5 * (eigvals_desc[..., 1] + eigvals_desc[..., 2])


def acylindricity(eigvals_desc: torch.Tensor) -> torch.Tensor:
    """Acylindricity from descending eigenvalues (reference: utilities.py:633)."""
    return eigvals_desc[..., 1] - eigvals_desc[..., 2]


def relative_shape_anisotropy(eigvals_desc: torch.Tensor) -> torch.Tensor:
    """Relative shape anisotropy in [0, 1] from descending eigenvalues
    (reference: utilities.py:640)."""
    e = eigvals_desc
    s = e.sum(-1)
    pair = e[..., 0] * e[..., 1] + e[..., 0] * e[..., 2] + e[..., 1] * e[..., 2]
    return 1.0 - 3.0 * pair / (s * s)
