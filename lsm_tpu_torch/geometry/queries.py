"""Geometric queries and CSG on level-set fields (port of
:mod:`lsm_tpu.geometry.queries`): smoothed Heaviside and delta, volume,
perimeter, the centered-difference gradient, gradient norm, unit normal,
Hessian and mean curvature of a field (and of a padded tensor), and min/max
constructive solid geometry. Plain torch: the JAX package has no kernel
here."""

from __future__ import annotations

import math

import torch

from ..core.bc import LinearExtrapolation
from ..core.field import MeshField
from ..ops import stencils as st

__all__ = [
    "smooth_heaviside",
    "smooth_delta",
    "volume",
    "perimeter",
    "gradient_from_padded",
    "grad_norm_from_padded",
    "hessian_from_padded",
    "curvature_from_padded",
    "gradient",
    "grad_norm",
    "normal",
    "hessian",
    "curvature",
    "union",
    "intersection",
    "complement",
    "difference",
]


def smooth_heaviside(x, alpha):
    """Smoothed Heaviside with transition half-width ``alpha``."""
    core = 0.5 * (1.0 + x / alpha + torch.sin(math.pi * x / alpha) / math.pi)
    return torch.where(x > alpha, 1.0, torch.where(x < -alpha, 0.0, core))


def smooth_delta(x, alpha):
    """Smoothed Dirac delta with support ``|x| <= alpha``."""
    return torch.where(torch.abs(x) > alpha, 0.0,
                       0.5 / alpha * (1.0 + torch.cos(math.pi * x / alpha)))


def volume(phi: MeshField) -> torch.Tensor:
    """Measure of ``{phi <= 0}`` via ``integral of H(-phi)`` with the smoothed
    Heaviside of half-width ``min(h)``."""
    _check_scalar(phi)
    alpha = phi.grid.min_spacing
    return phi.grid.cell_volume * torch.sum(smooth_heaviside(-phi.values, alpha))


def perimeter(phi: MeshField) -> torch.Tensor:
    """Measure of ``{phi = 0}`` via ``integral of delta(phi) |grad(phi)|``;
    border contributions neglected. A linear-extrapolation BC is supplied
    when the field has none."""
    _check_scalar(phi)
    if not phi.has_bcs():
        phi = phi.with_bcs(LinearExtrapolation())
    alpha = phi.grid.min_spacing
    p = phi.pad(st.PAD_D0)
    gn = grad_norm_from_padded(p, phi.spacing, st.PAD_D0, phi.shape)
    return phi.grid.cell_volume * torch.sum(smooth_delta(phi.values, alpha) * gn)


def gradient_from_padded(p, spacing, g, shape):
    """Centered-difference gradient components."""
    return tuple(st.d0(p, ax, h, g, shape) for ax, h in enumerate(spacing))


def grad_norm_from_padded(p, spacing, g, shape) -> torch.Tensor:
    sq = 0.0
    for c in gradient_from_padded(p, spacing, g, shape):
        sq = sq + c * c
    return st.safe_sqrt(sq)


def hessian_from_padded(p, spacing, g, shape):
    """Upper-triangular dict ``{(i, j): d2 phi / dx_i dx_j}``."""
    n = len(spacing)
    H = {}
    for i in range(n):
        H[(i, i)] = st.d2c(p, i, spacing[i], g, shape)
        for j in range(i + 1, n):
            H[(i, j)] = st.d2_mixed(p, i, j, spacing[i], spacing[j], g, shape)
    return H


def curvature_from_padded(p, spacing, g, shape) -> torch.Tensor:
    """Mean curvature ``(lap(phi) |grad|^2 - grad^T H grad) / |grad|^3``,
    zero where ``|grad|^2`` is below the dtype's epsilon. Needs the edge
    ghosts (two axes offset at once) of ``p``."""
    grad = gradient_from_padded(p, spacing, g, shape)
    H = hessian_from_padded(p, spacing, g, shape)
    n = len(spacing)
    nrmsq = 0.0
    for c in grad:
        nrmsq = nrmsq + c * c
    lap = 0.0
    quad = 0.0
    for i in range(n):
        lap = lap + H[(i, i)]
        quad = quad + grad[i] * grad[i] * H[(i, i)]
        for j in range(i + 1, n):
            quad = quad + 2.0 * grad[i] * grad[j] * H[(i, j)]
    safe = nrmsq >= torch.finfo(p.dtype).eps
    nrmsq_safe = torch.where(safe, nrmsq, 1.0)
    kappa = (lap * nrmsq_safe - quad) / nrmsq_safe ** 1.5
    return torch.where(safe, kappa, 0.0)


def _padded(phi: MeshField, width: int):
    _check_scalar(phi)
    return phi.pad(width)


def gradient(phi: MeshField) -> torch.Tensor:
    """Centered-difference gradient, stacked on a leading component axis."""
    p = _padded(phi, st.PAD_D0)
    return torch.stack(gradient_from_padded(p, phi.spacing, st.PAD_D0, phi.shape))


def grad_norm(phi: MeshField) -> torch.Tensor:
    p = _padded(phi, st.PAD_D0)
    return grad_norm_from_padded(p, phi.spacing, st.PAD_D0, phi.shape)


def normal(phi: MeshField, min_norm: float = 0.0) -> torch.Tensor:
    """Unit exterior normal ``grad(phi)/|grad(phi)|`` (leading component
    axis); ``min_norm > 0`` bounds the divisor from below."""
    g = gradient(phi)
    nrm = torch.sqrt(torch.sum(g * g, dim=0))
    if min_norm > 0:
        nrm = torch.maximum(nrm, nrm.new_tensor(min_norm))
    return g / nrm


def hessian(phi: MeshField) -> torch.Tensor:
    """Dense symmetric Hessian, shape ``(ndim, ndim, *grid.shape)``."""
    p = _padded(phi, st.PAD_D0)
    H = hessian_from_padded(p, phi.spacing, st.PAD_D0, phi.shape)
    n = phi.ndim
    return torch.stack([torch.stack([H[(min(i, j), max(i, j))] for j in range(n)])
                        for i in range(n)])


def curvature(phi: MeshField) -> torch.Tensor:
    """Mean curvature (:func:`curvature_from_padded`)."""
    p = _padded(phi, st.PAD_D0)
    return curvature_from_padded(p, phi.spacing, st.PAD_D0, phi.shape)


def union(phi1: MeshField, phi2: MeshField) -> MeshField:
    """Union of the enclosed domains: ``min(phi1, phi2)``."""
    return phi1.with_values(torch.minimum(phi1.values, phi2.values))


def intersection(phi1: MeshField, phi2: MeshField) -> MeshField:
    """Intersection of the enclosed domains: ``max(phi1, phi2)``."""
    return phi1.with_values(torch.maximum(phi1.values, phi2.values))


def complement(phi: MeshField) -> MeshField:
    """Complement of the enclosed domain: ``-phi``."""
    return phi.with_values(-phi.values)


def difference(phi1: MeshField, phi2: MeshField) -> MeshField:
    """Set difference: ``max(phi1, -phi2)``."""
    return phi1.with_values(torch.maximum(phi1.values, -phi2.values))


def _check_scalar(phi: MeshField):
    if phi.is_vector:
        raise ValueError("operation only applies to real-valued (scalar) fields")
