"""Geometric queries on level-set fields (port of the measure part of
:mod:`lsm_tpu.geometry.queries`): smoothed Heaviside and delta, volume,
perimeter and the centered-difference gradient norm."""

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
    "grad_norm_from_padded",
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


def grad_norm_from_padded(p, spacing, g, shape) -> torch.Tensor:
    sq = 0.0
    for ax, h in enumerate(spacing):
        c = st.d0(p, ax, h, g, shape)
        sq = sq + c * c
    return st.safe_sqrt(sq)


def _check_scalar(phi: MeshField):
    if phi.is_vector:
        raise ValueError("operation only applies to real-valued (scalar) fields")
