"""The five canonical benchmark configurations (port of
:mod:`lsm_tpu.models.benchmarks`).

Each builder returns a ready :class:`~lsm_tpu_torch.equation.LevelSetEquation`
(plus the exact solution where one is known), or for configuration 5 a
loss-and-gradient function, on ``device`` (the card unless ``device="cpu"``),
so tests and on-card checks run the same configurations:

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
5. :func:`config5_shape_opt_3d` — 3D shape optimisation: a narrow band,
   a speed extended off the interface along normals, the gradient of a
   volume penalty through an RK3 ``rollout`` of normal motion (on the card
   the band stepper: K6, K7, K8 forward, autograd of the plain band
   composite backward).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from ..core.bc import Extrapolation, Periodic
from ..core.field import MeshField, sample
from ..core.grid import Grid
from ..core.narrowband import NarrowBandField
from ..equation import LevelSetEquation
from ..geometry.queries import volume
from ..integrators.explicit import RK3, ForwardEuler
from ..integrators.loop import rollout
from ..reinit.velocity_extension import extend_along_normals
from ..terms.terms import AdvectionTerm, CurvatureTerm, NormalMotionTerm
from . import shapes

__all__ = [
    "config1_circle_advection",
    "config2_zalesak",
    "config3_vortex_spiral",
    "config4_curvature_normal",
    "config5_shape_opt_3d",
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


def config5_shape_opt_3d(n: int = 64, nsteps: int = 8, target_volume: float = 0.3,
                         nlayers: int = 3, dtype=torch.float32, device=None):
    """Differentiable 3D shape optimisation through a full rollout.

    Returns ``(loss_and_grad, phi0, speed0)``: ``loss_and_grad(phi_values,
    speed_values)`` returns ``(loss, (dphi, dspeed))`` (``torch.autograd.grad``
    of the loss w.r.t. both). The loss evolves the banded level set under a
    normal-motion speed first extended off the interface along normals (10
    iterations), rolls out ``nsteps`` RK3 steps of ``dt = 0.4 h`` and
    penalises the volume mismatch ``(volume - target_volume)^2``: the sphere
    of radius 0.45 on ``[-1, 1]^3`` with ``n^3`` nodes and
    ``Extrapolation(1)``, the speed 0.1 everywhere.
    """
    grid = Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (n, n, n))
    phi0 = sample(shapes.sphere((0.0, 0.0, 0.0), 0.45), grid, Extrapolation(1), dtype=dtype,
                  device=device)
    speed0 = torch.full(grid.shape, 0.1, dtype=dtype, device=phi0.device)
    dt = float(torch.tensor(0.4, dtype=dtype) * grid.min_spacing)
    integrator = RK3()

    def loss_fn(phi_values, speed_values):
        phi = NarrowBandField(phi_values, grid, phi0.bcs, nlayers=nlayers, _normalized=True)
        speed = extend_along_normals(
            speed_values, MeshField(phi_values, grid, phi0.bcs, _normalized=True), nb_iters=10)
        term = NormalMotionTerm(MeshField(speed, grid, phi0.bcs, _normalized=True))
        out, _ = rollout(integrator, (term,), phi, 0.0, dt, nsteps)
        return (volume(out) - target_volume) ** 2

    def loss_and_grad(phi_values, speed_values):
        with torch.enable_grad():
            v = phi_values.detach().requires_grad_()
            s = speed_values.detach().requires_grad_()
            loss = loss_fn(v, s)
            dphi, dspeed = torch.autograd.grad(loss, (v, s))
        return loss.detach(), (dphi, dspeed)

    return loss_and_grad, phi0, speed0
