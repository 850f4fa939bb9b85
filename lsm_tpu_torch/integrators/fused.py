"""Fused evolution on the persistent padded layout (port of
:mod:`lsm_tpu.integrators.fused`).

The level set lives in the padded buffer between steps; each RK stage is one
K1 pass (:func:`~lsm_tpu_torch.ops.weno_v2.fused_stage`) plus one K2 shell
refresh (:func:`~lsm_tpu_torch.ops.weno_v2.refresh_ghosts_fast`), wrapped in
:func:`~lsm_tpu_torch.ops.weno_v2.fused_step_stage` so that a step is
differentiable (backward: K4, K3, K5). On CUDA tensors those are the
hand-written kernels; on CPU tensors their plain versions, which drive the
same control flow. One stepper serves ``integrate`` and ``rollout``.

This slice covers dense 3D fields with one WENO5 :class:`AdvectionTerm`
without ``update_func``, whose velocity is a vector ``MeshField`` or tensor
(streamed) or a callable ``f(xs, t)`` (evaluated into streamed tensors at
each stage time, at the kernel's node coordinates ``lo + i*h``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import bc as _bc
from ..core.field import MeshField
from ..ops import weno_v2 as v2
from ..terms.terms import AdvectionTerm, compute_cfl
from .explicit import RK2, RK3, ForwardEuler

__all__ = ["FusedStepper", "supports_fused", "unsupported_reason"]

# (alpha, beta, gamma / dt, stage-time offset / dt) per stage, SSP form; the
# aux buffer of every stage after the first is the step's input state
_STAGES = {
    ForwardEuler: ((0.0, 1.0, 1.0, 0.0),),
    RK2: ((0.0, 1.0, 1.0, 0.0), (0.5, 0.5, 0.5, 1.0)),
    RK3: ((0.0, 1.0, 1.0, 0.0), (0.75, 0.25, 0.25, 1.0),
          (1.0 / 3.0, 2.0 * (1.0 / 3.0), 2.0 * (1.0 / 3.0), 0.5)),
}


def _todo(what: str, item: str) -> str:
    return f"{what} is not ported to the fused path yet (ROADMAP.md queue 2, {item})"


def unsupported_reason(terms, phi: MeshField, integrator) -> Optional[str]:
    """Why ``(terms, phi, integrator)`` cannot take the fused stepper, naming
    the ROADMAP item that would add it; ``None`` when it can."""
    if phi.active_mask is not None:
        return ("the dense fused stepper takes dense fields only; a NarrowBandField "
                "goes to the band stepper")
    return _slice_reason(terms, phi, integrator)


def _slice_reason(terms, phi: MeshField, integrator) -> Optional[str]:
    """The checks the dense and the band stepper share: one WENO5
    ``AdvectionTerm`` without ``update_func`` on a 3D scalar field with BCs
    the kernels take, FE/RK2/RK3."""
    if not isinstance(terms, (tuple, list)):
        terms = (terms,)
    if len(terms) != 1 or not isinstance(terms[0], AdvectionTerm):
        return _todo("a term list other than one AdvectionTerm", "K1 term kinds")
    term = terms[0]
    if term.scheme != "weno5":
        return _todo(f"the {term.scheme!r} advection scheme", "general path (K10/K11)")
    if term.update_func is not None:
        return _todo("an AdvectionTerm with update_func", "update_func")
    if phi.ndim != 3:
        return _todo(f"a {phi.ndim}D field", "2D embedding")
    if phi.is_vector or phi.bcs is None:
        return "the fused path needs a scalar field with boundary conditions"
    if phi.dtype not in (torch.float32, torch.float64):
        return f"the fused kernels take float32 or float64, not {phi.dtype}"
    if type(integrator) not in _STAGES:
        return _todo(f"the integrator {type(integrator).__name__}", "general path (K10/K11)")
    for ax, n in enumerate(phi.shape):
        if n < v2.GHOST + 1:
            return f"axis {ax} has {n} nodes; the fused path needs >= {v2.GHOST + 1}"
        for b in phi.bcs[ax]:
            if isinstance(b, _bc.Extrapolation) and (b.degree > 7 or b.degree + 1 > n):
                return _todo(f"Extrapolation({b.degree}) on an axis of {n} nodes",
                             "K2 degree")
    vel = term.velocity
    if isinstance(vel, MeshField):
        if not vel.is_vector or vel.values.shape[0] != 3:
            return "an advection velocity MeshField must be a 3-component vector field"
    elif not callable(vel):
        if not isinstance(vel, torch.Tensor) or tuple(vel.shape) != (3, *phi.shape):
            return f"an advection velocity tensor must have shape (3, {', '.join(map(str, phi.shape))})"
    return None


def supports_fused(terms, phi: MeshField, integrator=None) -> bool:
    """Whether ``(terms, phi)`` qualifies for :class:`FusedStepper`."""
    return unsupported_reason(terms, phi, integrator or RK3()) is None


class FusedStepper:
    """Padded-state stepping for ``phi_t + u . grad(phi) = 0``.

    Usage::

        stepper = FusedStepper(terms, phi, integrator)
        P = stepper.pack(phi.values)
        for _ in range(nsteps):
            P = stepper.step(P, t, dt)
            t += dt
        values = stepper.unpack(P)
    """

    def __init__(self, terms, phi: MeshField, integrator):
        terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
        reason = unsupported_reason(terms, phi, integrator)
        if reason is not None:
            raise NotImplementedError(reason)
        self.terms = terms
        self.grid = phi.grid
        self.bcs = phi.bcs
        self.shape = tuple(phi.shape)
        self.spacing = tuple(float(h) for h in phi.spacing)
        self.lo = tuple(float(x) for x in phi.grid.lo)
        self.dtype, self.device = phi.dtype, phi.device
        self.stages = _STAGES[type(integrator)]
        vel = terms[0].velocity
        if callable(vel) and not isinstance(vel, MeshField):
            self.spec = (v2.TermSpec("advection", "analytic", vel), ())
        else:
            values = vel.values if isinstance(vel, MeshField) else vel
            streams = tuple(values[d].to(device=self.device, dtype=self.dtype).contiguous()
                            for d in range(3))
            self.spec = (v2.TermSpec("advection", "stream", None, 3), streams)

    def pack(self, values: torch.Tensor) -> torch.Tensor:
        return v2.pack_padded(values, self.bcs)

    def unpack(self, padded: torch.Tensor) -> torch.Tensor:
        return v2.unpack_padded(padded, self.shape)

    def velocity(self, t):
        """The three streamed velocity components at time ``t``."""
        spec, streams = self.spec
        if spec.coef_kind == "stream":
            return streams
        xs = v2.node_coords(self.shape, self.spacing, self.lo, self.dtype, self.device)
        return v2.eval_components(spec.coef_static(xs, t), self.shape, self.dtype,
                                  self.device)

    def stage(self, P, coeffs, t_stage, aux, coeff_values=None):
        """One stage: K1 into a fresh buffer, then K2 on its shells; through
        :func:`~lsm_tpu_torch.ops.weno_v2.fused_step_stage`, so gradients
        flow when an input requires them (backward K4, K3, K5)."""
        return v2.fused_step_stage(P, self.velocity(t_stage), coeffs, aux, self.bcs,
                                   self.spacing, self.shape, coeff_values)

    def step(self, P: torch.Tensor, t, dt, dt_value=None) -> torch.Tensor:
        """One accepted step; returns a new padded buffer (``P`` is kept as
        the aux input of the later stages and not modified). ``t`` and ``dt``
        may be tensors (then the stage coefficients and a callable velocity
        carry their gradients); the kernels take ``dt_value`` (default
        ``float(dt)``) as the host number."""
        dtv = float(dt) if dt_value is None else float(dt_value)
        cur = P
        for s, (alpha, beta, g, off) in enumerate(self.stages):
            cur = self.stage(cur, (alpha, beta, g * dt), t + off * dt,
                             None if s == 0 else P, coeff_values=(alpha, beta, g * dtv))
        return cur

    def cfl(self, P: torch.Tensor, t) -> torch.Tensor:
        """Largest stable ``dt`` for the current padded state (0-d tensor)."""
        field = MeshField(self.unpack(P), self.grid, self.bcs, _normalized=True)
        return compute_cfl(self.terms, field, t)
