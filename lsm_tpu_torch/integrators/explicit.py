"""Explicit TVD Runge-Kutta time integrators (port of
:mod:`lsm_tpu.integrators.explicit`).

Each integrator is a frozen dataclass with ``advance(terms, phi, t, dt) ->
(phi_new, terms_new)`` in SSP form: every stage is
``alpha*aux + beta*phi - gamma*L(phi, t)``, one kernel pass (K10 or K11 on
the card) when the term list is a single WENO5 advection term. Terms are
re-``update``-d at every stage with the stage state and time. ``cfl`` is the
safety factor. ``dt_value`` is ``dt`` as a host number for the kernels, so
a tensor ``dt`` is not read back at every stage (default: ``dt`` itself).
"""

from __future__ import annotations

import dataclasses

from ..core.field import MeshField
from ..terms.terms import fused_stage_term, total_rhs, update_terms

__all__ = ["TimeIntegrator", "ForwardEuler", "RK2", "RK3"]


def _stage(terms, phi, t, aux, coeffs, values):
    """One RK stage ``alpha*aux + beta*phi - gamma*L(phi, t)`` as values:
    :meth:`AdvectionTerm.stage_values` (one kernel pass, taking the
    coefficients' host numbers ``values``) when the list is one WENO5
    advection term, otherwise the generic rhs and axpy."""
    term = fused_stage_term(terms)
    if term is not None:
        return term.stage_values(phi, t, aux, coeffs, values)
    alpha, beta, gamma = coeffs
    out = beta * phi.values - gamma * total_rhs(terms, phi, t)
    if aux is not None:
        out = alpha * aux + out
    return out


@dataclasses.dataclass(frozen=True)
class TimeIntegrator:
    cfl: float = 0.5

    def advance(self, terms, phi: MeshField, t, dt, dt_value=None):
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError

    def __repr__(self):
        return f"{self.describe()}\n  `- cfl: {self.cfl}"


@dataclasses.dataclass(frozen=True, repr=False)
class ForwardEuler(TimeIntegrator):
    """First-order explicit forward Euler."""

    def advance(self, terms, phi, t, dt, dt_value=None):
        h = dt if dt_value is None else dt_value
        terms = update_terms(terms, phi, t)
        return phi.with_values(_stage(terms, phi, t, None, (0.0, 1.0, dt), (0.0, 1.0, h))), terms

    def describe(self):
        return "ForwardEuler (1st order explicit)"


@dataclasses.dataclass(frozen=True, repr=False)
class RK2(TimeIntegrator):
    """Second-order TVD Runge-Kutta (Heun), in SSP form:
    ``pred = phi - dt L(phi)``; ``phi_new = 1/2 phi + 1/2 (pred - dt L(pred))``."""

    def advance(self, terms, phi, t, dt, dt_value=None):
        h = dt if dt_value is None else dt_value
        terms = update_terms(terms, phi, t)
        pred = phi.with_values(_stage(terms, phi, t, None, (0.0, 1.0, dt), (0.0, 1.0, h)))
        terms = update_terms(terms, pred, t + dt)
        phi_new = phi.with_values(_stage(terms, pred, t + dt, phi.values, (0.5, 0.5, 0.5 * dt),
                                         (0.5, 0.5, 0.5 * h)))
        return phi_new, terms

    def describe(self):
        return "RK2 (2nd order TVD Runge-Kutta, Heun's method)"


@dataclasses.dataclass(frozen=True, repr=False)
class RK3(TimeIntegrator):
    """Third-order Shu-Osher TVD Runge-Kutta:
    ``u1 = phi - dt L(phi)``; ``u2 = 3/4 phi + 1/4 u1 - 1/4 dt L(u1)``;
    ``out = 1/3 phi + 2/3 u2 - 2/3 dt L(u2)``."""

    def advance(self, terms, phi, t, dt, dt_value=None):
        h = dt if dt_value is None else dt_value
        terms = update_terms(terms, phi, t)
        u1 = phi.with_values(_stage(terms, phi, t, None, (0.0, 1.0, dt), (0.0, 1.0, h)))
        terms = update_terms(terms, u1, t + dt)
        u2 = phi.with_values(_stage(terms, u1, t + dt, phi.values, (0.75, 0.25, 0.25 * dt),
                                    (0.75, 0.25, 0.25 * h)))
        terms = update_terms(terms, u2, t + 0.5 * dt)
        third = 1.0 / 3.0
        new_vals = _stage(terms, u2, t + 0.5 * dt, phi.values,
                          (third, 2.0 * third, 2.0 * third * dt),
                          (third, 2.0 * third, 2.0 * third * h))
        return phi.with_values(new_vals), terms

    def describe(self):
        return "RK3 (3rd order TVD Runge-Kutta)"

