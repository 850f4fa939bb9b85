"""Time-loop drivers (port of :mod:`lsm_tpu.integrators.loop`).

- :func:`step` — one accepted step of the general path.
- :func:`evolve` — the adaptive CFL-driven host loop that
  ``LevelSetEquation.integrate`` runs, landing exactly on ``tf``.
- :func:`rollout` — ``nsteps`` fixed steps, differentiable with
  ``torch.autograd``: on a configuration the fused stepper takes (dense 3D
  or 2D), every stage is :func:`~lsm_tpu_torch.ops.weno_v2.fused_step_stage`
  (forward K1 + K2, backward K4, then K3 for one WENO5 advection term or K3'
  for any other term list, then K5), on the card and on the CPU alike; terms
  with ``update_func`` are refreshed before every stage and threaded
  through (JAX's ``_step_terms_impl``). On CUDA a gradient through the 2D
  embedding raises (2D gradient).
  ``fast="off"`` and the configurations the steppers do not take run the
  general path (:meth:`TimeIntegrator.advance`: K10/K11 forward for one
  WENO5 advection term, the plain VJP backward), differentiable everywhere.

A :class:`~lsm_tpu_torch.core.narrowband.NarrowBandField` re-tubes after
every step. On the card its rollout runs the band stepper (K6, K7, K8 in the
forward, a 2D band their 2D entries); under a gradient each stage is
:func:`~lsm_tpu_torch.ops.band.band_step_stage`, whose backward is autograd
of the plain band composite (as JAX's is ``jax.vjp`` of its dense
composite), and the re-tube stays out of the graph. With ``fast="off"`` it
takes the general path. On the CPU a band takes the general path,
differentiable through torch autograd.

``remat`` wraps each step in ``torch.utils.checkpoint`` (non-reentrant), so a
differentiated rollout keeps one step-input buffer per step and recomputes
the step's stages in the backward; ``remat_chunk=K`` nests a second
checkpoint over K-step chunks (``nsteps/K + K`` saved buffers). A rollout
that nothing differentiates pays nothing for either.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.field import MeshField
from ..core.narrowband import NarrowBandField
from ..ops.band import tile_grid
from . import band_fused as _band
from .explicit import TimeIntegrator
from .fused import FusedStepper, gradient_reason, unsupported_reason

__all__ = ["step", "evolve", "rollout"]


def step(integrator: TimeIntegrator, terms, phi, t, dt):
    """One accepted step of ``integrator``: ``(phi_new, terms_new)``."""
    return integrator.advance(terms, phi, t, dt)


def _checkpointed(fn, carry):
    return checkpoint(lambda *c: fn(c), *carry, use_reentrant=False,
                      preserve_rng_state=False)


def _scan_steps(step_fn, carry, nsteps: int, remat: bool, remat_chunk: Optional[int]):
    """``carry = step_fn(carry)`` ``nsteps`` times; each step checkpointed
    when ``remat``, and chunks of ``remat_chunk`` steps checkpointed around
    those (port of ``lsm_tpu.integrators.loop._scan_steps``)."""
    def one(c):
        return _checkpointed(step_fn, c) if remat else step_fn(c)

    def run(c, n):
        for _ in range(n):
            c = one(c)
        return c

    if remat and remat_chunk and nsteps > remat_chunk:
        chunk = int(remat_chunk)
        nchunks, rem = divmod(nsteps, chunk)
        for _ in range(nchunks):
            carry = _checkpointed(lambda c: run(c, chunk), carry)
        return run(carry, rem)
    return run(carry, nsteps)


def rollout(integrator: TimeIntegrator, terms, phi: MeshField, t0, dt, nsteps: int,
            unroll: int = 1, fast: str = "auto", remat: bool = True,
            remat_chunk: Optional[int] = None):
    """``nsteps`` steps of size ``dt`` from ``t0``; returns ``(phi, terms)``.
    The parameters are JAX's, in JAX's order.

    Differentiable: gradients flow to ``phi.values``, a streamed
    coefficient, and ``t0``/``dt`` when they are tensors that require them
    (through the stage coefficients and a callable coefficient: K3″'s time
    cotangent for a traced one, its own graph for one on the stream route).
    A tensor ``dt`` is read back once per call, for the kernels'
    coefficients, and a tensor ``t0`` once per step when a traced callable
    depends on the time.

    ``unroll`` is accepted and ignored: JAX unrolls its ``lax.scan``; here
    the steps are a Python loop. ``fast="auto"`` takes the fused stepper
    when the configuration qualifies (dense 3D or 2D, terms of the fused
    stage's kinds, FE/RK2/RK3), on the card and on the CPU, and the band
    stepper for a CUDA band; ``fast="off"`` and other configurations take
    the general path. On CUDA a gradient the card cannot run raises
    ``NotImplementedError``
    (:func:`~lsm_tpu_torch.integrators.fused.gradient_reason`). ``remat``
    and ``remat_chunk`` as in the module docstring.
    """
    if fast not in ("auto", "off"):
        raise ValueError(f"fast must be 'auto' or 'off', got {fast!r}")
    terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
    nsteps = int(nsteps)
    band = isinstance(phi, NarrowBandField)
    cuda = phi.values.is_cuda
    if fast == "auto" and (cuda or not band):
        reason = (_band.unsupported_reason if band else unsupported_reason)(terms, phi,
                                                                           integrator)
        if reason is None:
            if band:
                return _band_rollout(integrator, terms, phi, t0, dt, nsteps, remat, remat_chunk)
            return _fused_rollout(integrator, terms, phi, t0, dt, nsteps, remat, remat_chunk)
    dt_value = _host(dt)

    if band:
        def band_step(c):
            values, mask, tms, t = c
            field = NarrowBandField(values, phi.grid, phi.bcs, mask, phi.nlayers,
                                    _normalized=True)
            new, tms = integrator.advance(tms, field, t, dt, dt_value)
            new = new.update_band()
            return new.values, new.mask, tms, t + dt

        values, mask, terms, _ = _scan_steps(band_step, (phi.values, phi.mask, terms, t0),
                                             nsteps, remat, remat_chunk)
        return NarrowBandField(values, phi.grid, phi.bcs, mask, phi.nlayers,
                               _normalized=True), terms

    def general_step(c):
        values, tms, t = c
        new, tms = integrator.advance(tms, phi.with_values(values), t, dt, dt_value)
        return new.values, tms, t + dt

    values, terms, _ = _scan_steps(general_step, (phi.values, terms, t0), nsteps, remat,
                                   remat_chunk)
    return phi.with_values(values), terms


def _fused_rollout(integrator, terms, phi, t0, dt, nsteps, remat, remat_chunk):
    """The fused stepper's rollout; on CUDA a gradient it cannot run
    (:func:`~.fused.gradient_reason`) is refused before any stage runs."""
    stepper = FusedStepper(terms, phi, integrator)
    if phi.values.is_cuda and _needs_grad(stepper, phi, t0, dt):
        why = gradient_reason(terms, phi)
        if why is not None:
            raise NotImplementedError(why)
    dt_value = _host(dt)
    if stepper.has_update:
        def update_step(c):
            P, t, tms = c
            P, tms = stepper.step_with_terms(P, t, dt, tms, dt_value)
            return P, t + dt, tms

        P, _, terms = _scan_steps(update_step, (stepper.pack(phi.values), t0, terms), nsteps,
                                  remat, remat_chunk)
        return phi.with_values(stepper.unpack(P).contiguous()), terms

    def fused_step(c):
        P, t = c
        return stepper.step(P, t, dt, dt_value), t + dt

    P, _ = _scan_steps(fused_step, (stepper.pack(phi.values), t0), nsteps, remat, remat_chunk)
    return phi.with_values(stepper.unpack(P).contiguous()), terms


def _host(x) -> float:
    """``x`` as a host number (one read-back for a tensor)."""
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def _needs_grad(stepper, phi, t0, dt) -> bool:
    streams = [a for _, arrs in stepper.entries for a in arrs]
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in (phi.values, t0, dt, *streams))


def _band_rollout(integrator, terms, phi, t0, dt, nsteps, remat=True, remat_chunk=None):
    """A CUDA band rollout: the band stepper, re-tubing every step with a
    dispatch list as large as the tile grid (so it cannot overflow and
    nothing is read back). Under a gradient every stage is differentiable
    and each step is checkpointed when ``remat`` (counterpart of JAX's
    ``_fused_rollout`` on a band, capacity = all tiles); the re-tube
    recomputes the same masks in the backward (K8 is bit-equal to its plain
    version, and the stepper re-tubes a copy of the band). ``t0`` and ``dt``
    may be tensors."""
    total = math.prod(tile_grid(phi.shape, _band.default_tiles(phi.nlayers, phi.ndim)))
    stepper = _band.FusedBandStepper(terms, phi, integrator, capacity=total)
    dt_value = _host(dt)

    def band_step(c):
        state, t = c
        return stepper.step(state, t, dt, dt_value=dt_value), t + dt

    state, _ = _scan_steps(band_step, (stepper.pack(phi), t0), nsteps, remat, remat_chunk)
    return stepper.unpack(state, check=False), terms


def evolve(integrator: TimeIntegrator, terms, phi: MeshField, t0, tf, dt_max=math.inf,
           max_steps: Optional[int] = None):
    """Evolve ``phi`` from ``t0`` to exactly ``tf`` with adaptive CFL steps
    (the host loop of ``LevelSetEquation.integrate``, which routes a CUDA
    state to the kernels). Returns ``(phi, terms, t, nsteps)``, ``t`` the
    time reached (``tf`` unless ``max_steps`` stopped the loop first)."""
    from ..equation import LevelSetEquation  # equation.py imports this module

    eq = LevelSetEquation(terms=terms, ic=phi, integrator=integrator, t=float(t0))
    eq.integrate(tf, dt_max, max_steps=max_steps)
    return eq.state, eq.terms, eq.t, eq.last_nsteps
