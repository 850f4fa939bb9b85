"""Velocity extension off the interface along normals (port of
:mod:`lsm_tpu.reinit.velocity_extension`; Peng et al. 1999).

Solve in pseudo-time ``dF/dtau + sign(phi) n . grad(F) = 0`` with first-order
upwinding biased by the precomputed smoothed-signed-normal components
``a_d = S * grad(phi)_d / |grad(phi)|``, ``S = phi / sqrt(phi^2 + dx^2)``,
holding a Dirichlet-frozen mask of near-interface nodes fixed. Plain torch on
the field's device: the JAX package runs it as an XLA ``fori_loop`` and has
no kernel for it. Differentiable in ``F`` and in ``phi``: the gradient
reaches ``phi`` through the components ``a_d``, as ``jax.grad`` takes it;
only the frozen mask and the upwind selection are boolean.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.bc import LinearExtrapolation
from ..core.field import MeshField
from ..ops import stencils as st

__all__ = ["extend_along_normals"]


def _signed_normal_components(phi: MeshField, dx, min_norm):
    """``a_d = S grad(phi)_d / |grad|`` with centered differences; zero where
    the gradient (squared) norm is below ``min_norm^2``."""
    g = st.PAD_D0
    p = phi.pad(g)
    comps = [st.d0(p, ax, h, g, phi.shape) for ax, h in enumerate(phi.spacing)]
    norm_sq = sum(c * c for c in comps)
    ok = norm_sq > min_norm * min_norm
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, norm_sq, 1.0)), 0.0)
    S = phi.values / torch.sqrt(phi.values ** 2 + dx * dx)
    return [S * c * inv for c in comps]


def _extend(F: MeshField, a_comps, frozen, tau, nb_iters: int) -> MeshField:
    g = st.PAD_D0
    shape, spacing = F.shape, F.spacing
    upwind = [a > 0 for a in a_comps]
    for _ in range(nb_iters):
        p = F.pad(g)
        adv = 0.0
        for ax, h in enumerate(spacing):
            adv = adv + a_comps[ax] * torch.where(upwind[ax], st.dm(p, ax, h, g, shape),
                                                  st.dp(p, ax, h, g, shape))
        F = F.with_values(torch.where(frozen, F.values, F.values - tau * adv))
    return F


def extend_along_normals(
    F: Union[MeshField, torch.Tensor],
    phi: MeshField,
    nb_iters: int = 50,
    cfl: float = 0.45,
    frozen: Optional[torch.Tensor] = None,
    interface_band: float = 1.5,
    min_norm: float = 1e-14,
) -> Union[MeshField, torch.Tensor]:
    """Extend the scalar speed field ``F`` away from the interface of ``phi``.

    ``frozen`` (bool tensor or ``MeshField``) marks Dirichlet-held nodes; by
    default the band ``|phi| <= interface_band * min(h)``. Returns the same
    kind (tensor or ``MeshField``) as the input.
    """
    if nb_iters < 0:
        raise ValueError("nb_iters must be non-negative")
    if cfl <= 0:
        raise ValueError("cfl must be strictly positive")
    if interface_band < 0:
        raise ValueError("interface_band must be non-negative")
    if min_norm < 0:
        raise ValueError("min_norm must be non-negative")

    as_field = isinstance(F, MeshField)
    if as_field:
        if F.grid != phi.grid:
            raise ValueError("F and phi must be defined on the same mesh")
        F_values = F.values
    else:
        F_values = torch.as_tensor(F)
        if tuple(F_values.shape) != tuple(phi.shape):
            raise ValueError("F and phi must have the same size")
    if not F_values.is_floating_point():
        raise ValueError("F must have floating-point element type")

    bcs = phi.bcs
    if bcs is None:
        phi = phi.with_bcs(LinearExtrapolation())
        bcs = phi.bcs
    Ff = MeshField(F_values, phi.grid, bcs, _normalized=True)

    dx = phi.grid.min_spacing
    if frozen is None:
        frozen_mask = torch.abs(phi.values) <= interface_band * dx
    else:
        if isinstance(frozen, MeshField):
            frozen = frozen.values
        frozen = torch.as_tensor(frozen, device=phi.values.device)
        if tuple(frozen.shape) != tuple(phi.shape):
            raise ValueError("frozen mask must have the same size as phi")
        if frozen.dtype != torch.bool:
            raise ValueError("frozen mask must contain Bool values")
        frozen_mask = frozen

    a = _signed_normal_components(phi, dx, min_norm)
    out = _extend(Ff, a, frozen_mask, cfl * dx, nb_iters)
    if as_field:
        return F.with_values(out.values)
    return out.values
