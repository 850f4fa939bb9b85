"""Time-loop helpers (port of the ``step`` of :mod:`lsm_tpu.integrators.loop`).

``step`` is one accepted step of the general path, which
``LevelSetEquation.integrate`` takes on the CPU for configurations outside
the fused stepper. The device-resident ``evolve`` loop and the
differentiable ``rollout`` arrive with the gradient slice (ROADMAP.md
queue 1, slice 2).
"""

from __future__ import annotations

from .explicit import TimeIntegrator

__all__ = ["step"]


def step(integrator: TimeIntegrator, terms, phi, t, dt):
    """One accepted step of ``integrator``: ``(phi_new, terms_new)``."""
    return integrator.advance(terms, phi, t, dt)
