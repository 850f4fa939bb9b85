"""Hamilton-Jacobi terms of ``phi_t + sum_n term_n = 0`` (port of the
advection part of :mod:`lsm_tpu.terms.terms`).

Each term has ``rhs(phi, t)`` (whole-grid contribution), ``cfl_dt(phi, t)``
(largest stable time step) and ``update(phi, t)`` (a refreshed term).

A velocity may be a vector :class:`~lsm_tpu_torch.core.field.MeshField`, a
tensor of shape ``(ndim, *grid.shape)``, or a callable ``f(xs, t)`` of the
broadcastable node-coordinate tensors and time.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.field import MeshField
from ..ops import stencils as st

__all__ = ["AdvectionTerm", "compute_cfl", "total_rhs", "update_terms"]


def _eval_vector_field(f, phi: MeshField, t) -> Tuple[torch.Tensor, ...]:
    """A velocity as a tuple of per-component node tensors."""
    ndim = phi.ndim
    if isinstance(f, MeshField):
        if not f.is_vector:
            raise ValueError("advection velocity MeshField must be vector-valued")
        return tuple(f.values[d] for d in range(ndim))
    if callable(f):
        xs = phi.grid.coords(dtype=phi.dtype, device=phi.device)
        comps = f(xs, t)
        if isinstance(comps, (tuple, list)):
            return tuple(
                torch.broadcast_to(
                    torch.as_tensor(c, dtype=phi.dtype, device=phi.device), phi.shape)
                for c in comps)
        return tuple(comps[d] for d in range(ndim))
    return tuple(f[d] for d in range(ndim))


def _masked_max(x: torch.Tensor, mask) -> torch.Tensor:
    """Max of a nonnegative quantity over the active nodes (all nodes when
    ``mask`` is ``None``): off-band coefficients of a narrow band may be
    stale, so a CFL bound reduces over the band only."""
    if mask is None:
        return torch.max(x)
    return torch.max(torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device)))


class AdvectionTerm:
    """``u . grad(phi)`` with sign-of-velocity upwinding per dimension.
    ``scheme`` is ``"weno5"`` (default) or ``"upwind"``.

    ``update_func(velocity, phi, t) -> new_velocity`` refreshes a
    state-dependent velocity before the CFL estimate and at each RK stage.
    """

    def __init__(self, velocity, scheme: str = "weno5", update_func=None):
        if scheme not in ("weno5", "upwind"):
            raise ValueError(f"unknown scheme {scheme!r}; use 'weno5' or 'upwind'")
        self.velocity = velocity
        self.scheme = scheme
        self.update_func = update_func

    @property
    def pad_width(self) -> int:
        return st.PAD_WENO5 if self.scheme == "weno5" else st.PAD_D0

    def update(self, phi, t):
        if self.update_func is None:
            return self
        return AdvectionTerm(self.update_func(self.velocity, phi, t), self.scheme,
                             self.update_func)

    def rhs(self, phi, t):
        g = self.pad_width
        p = phi.pad(g)
        u = _eval_vector_field(self.velocity, phi, t)
        out = 0.0
        for ax, h in enumerate(phi.spacing):
            if self.scheme == "weno5":
                out = out + st.weno5_upwind(st.weno5_pair_diffs(p, ax, h, g, phi.shape), u[ax])
            else:
                dminus = st.dm(p, ax, h, g, phi.shape)
                dplus = st.dp(p, ax, h, g, phi.shape)
                out = out + u[ax] * torch.where(u[ax] > 0, dminus, dplus)
        return out

    def cfl_dt(self, phi, t):
        # unsplit multidimensional bound: dt * sum_d |u_d| / h_d <= 1
        u = _eval_vector_field(self.velocity, phi, t)
        s = 0.0
        for ax, h in enumerate(phi.spacing):
            s = s + torch.abs(u[ax]) / h
        return 1.0 / _masked_max(s, phi.active_mask)


def update_terms(terms: Sequence, phi: MeshField, t):
    """Refresh all state-dependent terms."""
    return tuple(term.update(phi, t) for term in terms)


def total_rhs(terms: Sequence, phi: MeshField, t) -> torch.Tensor:
    """Sum of the contributions of all terms, ``L(phi, t)``."""
    out = 0.0
    for term in terms:
        out = out + term.rhs(phi, t)
    return out


def compute_cfl(terms: Sequence, phi: MeshField, t) -> torch.Tensor:
    """Largest stable time step over all terms (a 0-d tensor; the caller
    validates positivity)."""
    out = terms[0].cfl_dt(phi, t)
    for term in terms[1:]:
        out = torch.minimum(out, term.cfl_dt(phi, t))
    return out
