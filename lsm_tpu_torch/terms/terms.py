"""Hamilton-Jacobi terms of ``phi_t + sum_n term_n = 0`` (port of
:mod:`lsm_tpu.terms.terms`): advection, normal motion, curvature motion and
eikonal reinitialization.

Each term has ``rhs(phi, t)`` (whole-grid contribution), ``cfl_dt(phi, t)``
(largest stable time step), ``update(phi, t)`` (a refreshed term) and
``pad_width``.

A velocity may be a vector :class:`~lsm_tpu_torch.core.field.MeshField`, a
tensor of shape ``(ndim, *grid.shape)``, or a callable ``f(xs, t)`` of the
broadcastable node-coordinate tensors and time. A scalar coefficient (speed,
curvature weight) may be a scalar ``MeshField``, a tensor of the grid's
shape, a number, or such a callable. A number's CFL bound is a host number:
it costs no pass over the grid.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ..core.field import MeshField
from ..ops import stencils as st
from ..ops.weno_general import weno_advection_rhs, weno_advection_stage

__all__ = [
    "AdvectionTerm",
    "NormalMotionTerm",
    "CurvatureTerm",
    "EikonalReinitializationTerm",
    "compute_cfl",
    "fused_stage_term",
    "total_rhs",
    "update_terms",
    "kind_cfl",
    "is_number",
]

#: a scalar coefficient or a velocity: a field, a tensor or a callable ``f(xs, t)``
#: (a number too, as the module docstring says)
Coefficient = Union[MeshField, torch.Tensor, Callable]


def is_number(f) -> bool:
    """Whether a coefficient is a plain Python number (a constant)."""
    return isinstance(f, (int, float)) and not isinstance(f, bool)


def _eval_scalar_field(f, phi: MeshField, t) -> torch.Tensor:
    """A scalar coefficient on the grid nodes."""
    if isinstance(f, MeshField):
        return f.values
    if callable(f):
        xs = phi.grid.coords(dtype=phi.dtype, device=phi.device)
        return torch.broadcast_to(torch.as_tensor(f(xs, t), dtype=phi.dtype, device=phi.device),
                                  phi.shape)
    return torch.broadcast_to(torch.as_tensor(f, dtype=phi.dtype, device=phi.device), phi.shape)


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


def kind_cfl(kind: str, coef, mask, spacing, like: torch.Tensor) -> torch.Tensor:
    """Largest stable time step of one term kind (a 0-d tensor of ``like``'s
    dtype and device), from its coefficient values ``coef``: the velocity
    components for advection, ``(speed,)`` or ``(b,)`` for normal motion or
    curvature (a tensor, or a number: then a host number, no pass over the
    grid), nothing for the eikonal term. Reduces over ``mask`` (all nodes
    when ``None``); the dense terms and the band stepper share it."""
    if kind == "eikonal":
        return torch.full((), min(spacing), dtype=like.dtype, device=like.device)
    if kind == "advection":
        # unsplit multidimensional bound: dt * sum_d |u_d| / h_d <= 1
        s = 0.0
        for u, h in zip(coef, spacing):
            s = s + torch.abs(u) / h
        return 1.0 / _masked_max(s, mask)
    c = coef[0]
    if is_number(c):
        mx = torch.full((), abs(float(c)), dtype=like.dtype, device=like.device)
    else:
        mx = _masked_max(torch.abs(c), mask)
    if kind == "normal":
        return 1.0 / (mx * sum(1.0 / h for h in spacing))
    hmin = min(spacing)
    return hmin * hmin / (2.0 * mx)


def _scalar_coef(f, phi: MeshField, t):
    """A scalar coefficient for :func:`kind_cfl`: a number as it is."""
    return (f,) if is_number(f) else (_eval_scalar_field(f, phi, t),)


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

    def stage_values(self, phi, t, aux_values, coeffs, coeff_values=None):
        """The RK stage ``alpha*aux + beta*phi - gamma*(u . grad phi)`` in one
        kernel pass (K10 in 3D, K11 in 2D on the card): the general path's
        stage for a single WENO5 advection term. ``coeffs = (alpha, beta,
        gamma)`` may be tensors; ``coeff_values`` are their host numbers (see
        :func:`~lsm_tpu_torch.ops.weno_general.weno_advection_stage`). Only
        valid for ``scheme == 'weno5'``."""
        p = phi.pad(self.pad_width)
        u = _eval_vector_field(self.velocity, phi, t)
        return weno_advection_stage(p, u, aux_values, tuple(coeffs), tuple(phi.spacing),
                                    tuple(phi.shape), coeff_values)

    def rhs(self, phi, t):
        g = self.pad_width
        p = phi.pad(g)
        u = _eval_vector_field(self.velocity, phi, t)
        if self.scheme == "weno5":
            return weno_advection_rhs(p, u, tuple(phi.spacing), tuple(phi.shape))
        # the first-order upwind scheme stays plain torch: JAX has no kernel for it
        out = 0.0
        for ax, h in enumerate(phi.spacing):
            dminus = st.dm(p, ax, h, g, phi.shape)
            dplus = st.dp(p, ax, h, g, phi.shape)
            out = out + u[ax] * torch.where(u[ax] > 0, dminus, dplus)
        return out

    def cfl_dt(self, phi, t):
        return kind_cfl("advection", _eval_vector_field(self.velocity, phi, t), phi.active_mask,
                        phi.spacing, phi.values)


class NormalMotionTerm:
    """``v |grad(phi)|`` through the Godunov Hamiltonian with second-order
    ENO one-sided derivatives. ``update_func(speed, phi, t) -> new_speed``
    refreshes a state-dependent speed (honoured on the general path)."""

    def __init__(self, speed, update_func=None):
        self.speed = speed
        self.update_func = update_func

    @property
    def pad_width(self) -> int:
        return st.PAD_ENO2

    def update(self, phi, t):
        if self.update_func is None:
            return self
        return NormalMotionTerm(self.update_func(self.speed, phi, t), self.update_func)

    def rhs(self, phi, t):
        g = self.pad_width
        p = phi.pad(g)
        v = _eval_scalar_field(self.speed, phi, t)
        grad_p, grad_m = st.godunov_norms(p, phi.spacing, g, phi.shape)
        return st.pos(v) * grad_p + st.neg(v) * grad_m

    def cfl_dt(self, phi, t):
        return kind_cfl("normal", _scalar_coef(self.speed, phi, t), phi.active_mask,
                        phi.spacing, phi.values)


class CurvatureTerm:
    """``b kappa |grad(phi)|``: parabolic mean-curvature motion, well posed
    for ``b <= 0``."""

    def __init__(self, b):
        self.b = b

    @property
    def pad_width(self) -> int:
        return st.PAD_ENO2  # the curvature reads edge ghosts; 2 is safe everywhere

    def update(self, phi, t):
        return self

    def rhs(self, phi, t):
        from ..geometry.queries import curvature_from_padded, grad_norm_from_padded

        g = self.pad_width
        p = phi.pad(g)
        b = _eval_scalar_field(self.b, phi, t)
        kappa = curvature_from_padded(p, phi.spacing, g, phi.shape)
        return b * kappa * grad_norm_from_padded(p, phi.spacing, g, phi.shape)

    def cfl_dt(self, phi, t):
        return kind_cfl("curvature", _scalar_coef(self.b, phi, t), phi.active_mask,
                        phi.spacing, phi.values)


class EikonalReinitializationTerm:
    """``sign(phi) (|grad(phi)| - 1)``: PDE reinitialization toward a signed
    distance function. With ``s0`` (a scalar ``MeshField``, see
    :meth:`from_initial`) the smoothed sign of the initial level set is
    frozen; with ``s0=None`` the sign is recomputed from the current ``phi``
    with gradient-aware smoothing."""

    def __init__(self, s0: Optional[MeshField] = None):
        self.s0 = s0

    @staticmethod
    def from_initial(phi0: MeshField) -> "EikonalReinitializationTerm":
        """Freeze the smoothed sign ``phi0 / sqrt(phi0^2 + dx^2)`` of the
        initial level set, ``dx`` the smallest spacing."""
        dx = phi0.grid.min_spacing
        return EikonalReinitializationTerm(phi0.map(lambda v: v / torch.sqrt(v * v + dx * dx)))

    @property
    def pad_width(self) -> int:
        return st.PAD_ENO2

    def update(self, phi, t):
        return self

    def rhs(self, phi, t):
        g = self.pad_width
        p = phi.pad(g)
        grad_p, grad_m = st.godunov_norms(p, phi.spacing, g, phi.shape)
        if self.s0 is None:
            v = phi.values
            norm = torch.where(torch.sign(v) > 0, grad_p, grad_m)
            dx = phi.grid.min_spacing
            denom = torch.sqrt(v ** 2 + norm ** 2 * dx * dx)
            s = torch.where(denom == 0, 0.0, v / torch.where(denom == 0, 1.0, denom))
        else:
            s = self.s0.values
            norm = torch.where(torch.sign(s) > 0, grad_p, grad_m)
        return s * (norm - 1.0)

    def cfl_dt(self, phi, t):
        return kind_cfl("eikonal", (), phi.active_mask, phi.spacing, phi.values)


def fused_stage_term(terms) -> Optional[AdvectionTerm]:
    """The single WENO5 :class:`AdvectionTerm` when the term list is one,
    whose RK stage is one kernel pass (:meth:`AdvectionTerm.stage_values`),
    else ``None``."""
    if len(terms) == 1 and isinstance(terms[0], AdvectionTerm) and terms[0].scheme == "weno5":
        return terms[0]
    return None


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
