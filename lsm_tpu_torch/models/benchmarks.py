"""The canonical 2D benchmark configurations (port of
:mod:`lsm_tpu.models.benchmarks`, configurations 1 to 4).

Each builder returns a ready :class:`~lsm_tpu_torch.equation.LevelSetEquation`
(plus the exact solution where one is known) on ``device`` (the card unless
``device="cpu"``), so tests and on-card checks run the same configurations:

1. :func:`config1_circle_advection` — 2D circle, constant advection,
   first-order upwind and forward Euler (the general path; JAX has no kernel
   for the upwind scheme).
2. :func:`config2_zalesak` — Zalesak disk rotation, WENO5 and TVD-RK3,
   periodic BCs (the area-loss check).
3. :func:`config3_vortex_spiral` — single-vortex stretch with cosine time
   reversal; the exact solution returns to the initial disk at ``t =
   period``.
4. :func:`config4_curvature_normal` — mean-curvature and normal motion of a
   star.

Configuration 5 (3D shape optimisation through a narrow band with velocity
extension) waits for velocity extension and the band backward (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from ..core.bc import Extrapolation, Periodic
from ..core.field import sample
from ..core.grid import Grid
from ..equation import LevelSetEquation
from ..integrators.explicit import RK3, ForwardEuler
from ..terms.terms import AdvectionTerm, CurvatureTerm, NormalMotionTerm
from . import shapes

__all__ = [
    "config1_circle_advection",
    "config2_zalesak",
    "config3_vortex_spiral",
    "config4_curvature_normal",
]


def config1_circle_advection(n: int = 100, dtype=None,
                             device=None) -> Tuple[LevelSetEquation, Callable]:
    """2D circle under constant advection u = (1, 0); upwind and forward
    Euler. Returns ``(equation, exact)``, ``exact(t)`` the translated
    circle."""
    grid = Grid((-2.0, -2.0), (2.0, 2.0), (n, n))
    phi = sample(shapes.circle((0.0, 0.0), 0.5), grid, dtype=dtype, device=device)
    u = lambda xs, t: (torch.ones_like(xs[0] + xs[1]), torch.zeros_like(xs[0] + xs[1]))
    eq = LevelSetEquation(terms=(AdvectionTerm(u, scheme="upwind"),), ic=phi,
                          bc=Extrapolation(1), integrator=ForwardEuler())

    def exact(t):
        return sample(shapes.circle((t, 0.0), 0.5), grid, dtype=dtype, device=device)

    return eq, exact


def config2_zalesak(n: int = 128, dtype=None, device=None) -> LevelSetEquation:
    """Zalesak slotted-disk rigid rotation on [0,1]^2; one revolution at
    t = 1."""
    grid = Grid((0.0, 0.0), (1.0, 1.0), (n, n))
    phi = sample(shapes.zalesak_disk(), grid, dtype=dtype, device=device)
    u = shapes.rigid_rotation_velocity((0.5, 0.5), 2.0 * math.pi)
    return LevelSetEquation(terms=(AdvectionTerm(u),), ic=phi, bc=Periodic(), integrator=RK3())


def config3_vortex_spiral(n: int = 128, period: float = 4.0, dtype=None,
                          device=None) -> LevelSetEquation:
    """Single-vortex spiral stretch with time reversal (exact return at
    ``t = period``)."""
    grid = Grid((0.0, 0.0), (1.0, 1.0), (n, n))
    phi = sample(shapes.circle((0.5, 0.75), 0.15), grid, dtype=dtype, device=device)
    u = shapes.vortex_velocity(period=period)
    return LevelSetEquation(terms=(AdvectionTerm(u),), ic=phi, bc=Extrapolation(2),
                            integrator=RK3())


def config4_curvature_normal(n: int = 100, b: float = -0.05, v: float = 0.2, dtype=None,
                             device=None) -> LevelSetEquation:
    """Mean-curvature flow and outward normal motion of a star."""
    grid = Grid((-1.0, -1.0), (1.0, 1.0), (n, n))
    phi = sample(shapes.star(), grid, dtype=dtype, device=device)
    return LevelSetEquation(terms=(CurvatureTerm(b), NormalMotionTerm(v)), ic=phi,
                            bc=Extrapolation(2), integrator=RK3())
