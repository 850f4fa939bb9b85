"""PDE reinitialization to a signed distance function (port of
:mod:`lsm_tpu.reinit.eikonal`).

An iterated Hamilton-Jacobi pseudo-time solve of

    d phi / d tau = - sign(phi0) (|grad phi| - 1)

with the Godunov Hamiltonian and second-order ENO one-sided derivatives, and
a subcell fix at interface-adjacent nodes so the zero contour does not move:
there the one-sided differences reach the quadratic (ENO) interface
location of ``phi0`` (Min, "On reinitializing level set functions", JCP
2010). Plain torch on the field's device: the JAX package runs it as one XLA
loop and has no kernel for it. This is what a ``posthook`` typically runs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.bc import LinearExtrapolation
from ..core.field import MeshField
from ..ops import stencils as st

__all__ = ["reinitialize", "reinit_rhs"]


def _offset(ax, k, n):
    return tuple(k if d == ax else 0 for d in range(n))


def _axis_crossing_distance(p0, ax, h, g, shape, dtype):
    """Per-node distances ``(s_m, s_p, cross_m, cross_p)`` to the zero
    crossing of phi0 along ``ax`` on the backward and forward side: with
    ``pxx = minmod(D2 phi0_i, D2 phi0_{i+1})`` (undivided) the crossing sits
    at ``h (1/2 + (p_i - p_{i+1} - sgn(p_i - p_{i+1}) sqrt(disc)) / pxx)``,
    ``disc = (pxx/2 - p_i - p_{i+1})^2 - 4 p_i p_{i+1}``, or at the linear
    secant ``h p_i / (p_i - p_{i+1})`` where the quadratic degenerates."""
    n = len(shape)
    c = st.shift(p0, (0,) * n, g, shape)
    nb_p = st.shift(p0, _offset(ax, 1, n), g, shape)
    nb_m = st.shift(p0, _offset(ax, -1, n), g, shape)
    d2 = st.d2c(p0, ax, h, g, shape) * (h * h)  # undivided second difference
    eps = 100.0 * torch.finfo(dtype).eps

    def one_side(nb, d2nb):
        cross = c * nb < 0
        pxx = st.minmod(d2, d2nb)
        denom_lin = c - nb
        lin = h * c / torch.where(denom_lin == 0, 1.0, denom_lin)
        disc = (0.5 * pxx - c - nb) ** 2 - 4.0 * c * nb
        sq = torch.sqrt(st.pos(disc))
        quad = h * (0.5 + (c - nb - torch.sign(c - nb) * sq) / torch.where(pxx == 0, 1.0, pxx))
        s = torch.where(torch.abs(pxx) > eps, quad, lin)
        # the crossing lies strictly inside (0, h]
        s = torch.clamp(s, eps * h, h)
        return torch.where(cross, s, h), cross

    # undivided D2 at the neighbours i+1 and i-1 (reach 2)
    d2_pl = st.shift(p0, _offset(ax, 2, n), g, shape) - 2.0 * nb_p + c
    d2_mi = st.shift(p0, _offset(ax, -2, n), g, shape) - 2.0 * nb_m + c
    s_p, cross_p = one_side(nb_p, d2_pl)
    s_m, cross_m = one_side(nb_m, d2_mi)
    return s_m, s_p, cross_m, cross_p


def reinit_rhs(phi: MeshField, s0_values: torch.Tensor) -> torch.Tensor:
    """Pseudo-time right-hand side ``s0 (|grad phi| - 1)`` with the frozen
    smoothed sign ``s0`` (the update away from the interface)."""
    g = st.PAD_ENO2
    p = phi.pad(g)
    grad_p, grad_m = st.godunov_norms(p, phi.spacing, g, phi.shape)
    norm = torch.where(s0_values > 0, grad_p, grad_m)
    return s0_values * (norm - 1.0)


def _godunov_subcell(f: MeshField, geo, spacing, g, shape):
    """``(|grad+|, |grad-|)`` of the current iterate with the one-sided
    differences at interface-adjacent nodes taken toward the interface
    point (Min, eq. 23)."""
    n = len(shape)
    p = f.pad(g)
    c = f.values
    gp2 = 0.0
    gm2 = 0.0
    for ax, h in enumerate(spacing):
        A, B = st.eno2_onesided(p, ax, h, g, shape)
        s_m, s_p, cross_m, cross_p = geo[ax]
        d2c = st.d2c(p, ax, h, g, shape)
        d2p = (st.shift(p, _offset(ax, 2, n), g, shape)
               - 2.0 * st.shift(p, _offset(ax, 1, n), g, shape) + c) / (h * h)
        d2m = (st.shift(p, _offset(ax, -2, n), g, shape)
               - 2.0 * st.shift(p, _offset(ax, -1, n), g, shape) + c) / (h * h)
        B_fix = (0.0 - c) / s_p - 0.5 * s_p * st.minmod(d2c, d2p)
        A_fix = c / s_m + 0.5 * s_m * st.minmod(d2c, d2m)
        A = torch.where(cross_m, A_fix, A)
        B = torch.where(cross_p, B_fix, B)
        gp2 = gp2 + st.pos(A) ** 2 + st.neg(B) ** 2
        gm2 = gm2 + st.neg(A) ** 2 + st.pos(B) ** 2
    return torch.sqrt(gp2), torch.sqrt(gm2)


def _reinitialize(phi: MeshField, iters: int, cfl, subcell: bool, band_width):
    g = st.PAD_ENO2
    dx = phi.grid.min_spacing
    dtype = phi.dtype
    shape = tuple(phi.shape)
    spacing = phi.spacing
    v0 = phi.values
    s0 = v0 / torch.sqrt(v0 ** 2 + dx * dx)  # frozen smoothed sign
    geo = None
    if subcell:
        # the interface locations of phi0 per axis, frozen across the solve
        p0 = phi.pad(g)
        geo = [_axis_crossing_distance(p0, ax, h, g, shape, dtype)
               for ax, h in enumerate(spacing)]
        iface = torch.zeros(shape, dtype=torch.bool, device=v0.device)
        smin = torch.full(shape, math.inf, dtype=dtype, device=v0.device)
        for s_m, s_p, cross_m, cross_p in geo:
            iface = iface | cross_m | cross_p
            smin = torch.minimum(smin, torch.where(cross_m, s_m, math.inf))
            smin = torch.minimum(smin, torch.where(cross_p, s_p, math.inf))
        # the exact sign at interface-adjacent nodes (the subcell stencils pin
        # the contour), the smoothed one elsewhere
        S = torch.where(iface, torch.sign(v0), s0)
        # the 1/s stiffness of the subcell stencils: dtau <= cfl * s there
        dtau = cfl * torch.clamp(smin, max=dx)
    else:
        S = s0
        dtau = cfl * dx
    # freeze nodes far outside the band: their value only needs the right sign
    active = None if band_width is None else torch.abs(v0) <= band_width
    f = phi
    for _ in range(iters):
        if subcell:
            grad_p, grad_m = _godunov_subcell(f, geo, spacing, g, shape)
            norm = torch.where(S > 0, grad_p, grad_m)
            new = f.values - dtau * S * (norm - 1.0)
        else:
            new = f.values - dtau * reinit_rhs(f, s0)
        if active is not None:
            new = torch.where(active, new, f.values)
        f = f.with_values(new.to(dtype))
    return f


def reinitialize(phi: MeshField, iters: Optional[int] = None, cfl: float = 0.45,
                 subcell: bool = True, band_width: Optional[float] = None) -> MeshField:
    """Reinitialize ``phi`` to (approximately) a signed distance function.

    - ``iters``: pseudo-time steps; by default enough to cover
      ``band_width`` (if given) or the domain's largest extent at unit speed.
    - ``cfl``: the pseudo-time step is ``cfl * min(h)``.
    - ``subcell``: pin the zero contour with the subcell fix (recommended).
    - ``band_width``: update only the nodes with ``|phi| <= band_width``;
      the others keep their (correctly signed) values.

    A field without boundary conditions gets linear extrapolation.
    """
    if not phi.has_bcs():
        phi = phi.with_bcs(LinearExtrapolation())
    if iters is None:
        dx = phi.grid.min_spacing
        reach = band_width if band_width is not None else max(
            b - a for a, b in zip(phi.grid.lo, phi.grid.hi))
        iters = int(math.ceil(reach / (cfl * dx))) + 5
    return _reinitialize(phi, iters, cfl, subcell, band_width)
