"""Geometric queries on level-set fields (port of part of
:mod:`lsm_tpu.geometry.queries`): smoothed Heaviside and delta, volume,
perimeter, and the centered-difference gradient, gradient norm, Hessian and
mean curvature on a padded tensor."""

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


def _check_scalar(phi: MeshField):
    if phi.is_vector:
        raise ValueError("operation only applies to real-valued (scalar) fields")
