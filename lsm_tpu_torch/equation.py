"""User-facing evolution API (port of :mod:`lsm_tpu.equation`).

``LevelSetEquation`` holds the terms, integrator, current state and time and
exposes ``integrate(tf)``: a host loop that recomputes the CFL bound every
accepted step (read back once per step) and advances the state.

Routing by the state's device and kind, as JAX routes on the TPU:

- Without hooks and with ``fast="auto"``: a dense 3D or 2D field (2D as
  ``(1, n0, n1)``) takes the fused stepper (kernels K1, K2;
  ``last_fast_path == "fused"``), a 3D or 2D
  :class:`~lsm_tpu_torch.core.narrowband.NarrowBandField` the band stepper
  (K6, K7, K8, a 2D band their 2D entries on its own ``(n0+6, n1+6)``
  layout; ``"band"``), for any list of advection, normal-motion, curvature
  and eikonal terms.
- Otherwise the general path (``last_fast_path is None``): hooks,
  ``fast="off"``, a term list the steppers do not take (the upwind scheme,
  an object that is no term kind, other integrators). Each RK stage is one
  K10 (3D) or K11 (2D) pass for a single WENO5 advection term, else the
  terms' ``rhs`` and an axpy; a band field is re-tubed after every step.
- Terms with ``update_func`` take the fused stepper on a dense field: each
  step refreshes them with the accepted state before the CFL bound, then
  before every stage (JAX's loop order), and the refreshed terms persist in
  ``self.terms``. On a band they take the general path, as in JAX.
- Every configuration JAX takes on its fused path takes the port's, an
  ``Extrapolation`` of any degree included (above 7 the ghost kernels read
  their weights from a device table). The kernels' plain versions run on
  CPU tensors; nothing on CUDA drops to them.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import torch

from .core.device import dtype_str
from .core.field import SHARDED_ONLY, MeshField
from .core.narrowband import NarrowBandField
from .geometry import queries as geo
from .integrators import band_fused as _band
from .integrators import loop as _loop
from .integrators.explicit import RK3, TimeIntegrator
from .integrators.fused import FusedStepper, unsupported_reason
from .terms.terms import compute_cfl as _compute_cfl, update_terms

__all__ = ["LevelSetEquation"]

Hook = Optional[Callable[["LevelSetEquation"], None]]


class LevelSetEquation:
    """``phi_t + sum_n term_n = 0``: terms, integrator, state and time.

    ``terms`` (one term or a sequence), ``ic`` (initial :class:`MeshField`,
    never mutated), ``bc`` (optional; wins over BCs already attached to
    ``ic``, with a warning when both are given; an error when neither is),
    ``integrator`` (default :class:`RK3`), ``t``.
    """

    def __init__(self, *, terms, ic: MeshField, bc=None,
                 integrator: TimeIntegrator = RK3(), t: float = 0.0):
        if getattr(ic, "is_sharded", False):
            raise TypeError(SHARDED_ONLY)
        if not isinstance(ic, MeshField):
            raise TypeError("ic must be a MeshField")
        self.terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
        if len(self.terms) == 0:
            raise ValueError("at least one term is required")
        if bc is not None:
            if ic.has_bcs():
                warnings.warn(
                    "both `bc` and boundary conditions on `ic` were provided; using `bc`")
            state = ic.with_bcs(bc, replace=True)
        elif ic.has_bcs():
            state = ic
        else:
            raise ValueError("no boundary conditions: provide `bc` or attach them to `ic`")
        self.state = state
        self.integrator = integrator
        self.t = float(t)
        #: which fast path the last integrate() took: "fused", "band" or None
        self.last_fast_path = None
        #: how many accepted steps the last integrate() took
        self.last_nsteps = 0

    @property
    def current_state(self) -> MeshField:
        return self.state

    @property
    def current_time(self) -> float:
        return self.t

    @property
    def grid(self):
        return self.state.grid

    @property
    def boundary_conditions(self):
        return self.state.bcs

    def volume(self):
        return geo.volume(self.state)

    def perimeter(self):
        return geo.perimeter(self.state)

    # -- evolution -----------------------------------------------------------------

    def integrate(self, tf: float, dt_max: float = math.inf, *, prehook: Hook = None,
                  posthook: Hook = None, max_steps: Optional[int] = None,
                  fast: str = "auto") -> "LevelSetEquation":
        """Advance the state to exactly ``tf``, or by at most ``max_steps``
        accepted steps. Hooks run once per accepted step and may mutate
        ``self.state`` / ``self.terms``. ``fast="off"`` forces the general
        path."""
        tf = float(tf)
        if tf < self.t:
            raise ValueError(f"tf = {tf} is before current time t = {self.t}")
        if fast not in ("auto", "off"):
            raise ValueError(f"fast must be 'auto' or 'off', got {fast!r}")
        self.last_fast_path = None
        self.last_nsteps = 0
        hooks = prehook is not None or posthook is not None
        band = isinstance(self.state, NarrowBandField)
        if self.state.values.is_cuda:
            stepper = self._cuda_stepper(hooks, fast)
        elif hooks or fast == "off":
            stepper = None
        elif band:
            stepper = (_band.FusedBandStepper(self.terms, self.state, self.integrator)
                       if _band.unsupported_reason(self.terms, self.state, self.integrator)
                       is None else None)
        else:
            stepper = (FusedStepper(self.terms, self.state, self.integrator)
                       if unsupported_reason(self.terms, self.state, self.integrator)
                       is None else None)
        if stepper is None:
            return self._integrate_general(tf, dt_max, prehook, posthook, max_steps)
        if band:
            return self._integrate_band(stepper, tf, dt_max, max_steps)
        return self._integrate_fast(stepper, tf, dt_max, max_steps)

    def _cuda_stepper(self, hooks: bool, fast: str):
        """The fused or band stepper for a CUDA state; ``None`` for the
        general path (hooks, ``fast="off"``, a configuration JAX sends to
        its general path)."""
        if self.state.dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(
                f"the CUDA kernels take float32 or float64, not {self.state.dtype}")
        if hooks or fast == "off":
            return None
        band = isinstance(self.state, NarrowBandField)
        reason = (_band.unsupported_reason if band else unsupported_reason)(
            self.terms, self.state, self.integrator)
        if reason is None:
            return (_band.FusedBandStepper if band else FusedStepper)(
                self.terms, self.state, self.integrator)
        return None

    def _eps(self, tf):
        return torch.finfo(self.state.dtype).eps * max(abs(tf), 1.0)

    @staticmethod
    def _checked_dt(cfl_dt: float) -> float:
        if not (cfl_dt > 0) or math.isnan(cfl_dt):
            raise ValueError(
                f"invalid time-step based on CFL condition: dt = {cfl_dt} "
                "(check for NaN/Inf in velocity or speed)")
        return cfl_dt

    def _check_finite(self):
        if not bool(torch.isfinite(self.state.values).all()):
            raise ArithmeticError(
                "non-finite state after integrate(); check for NaN/Inf velocities "
                "or an invalid CFL time step")

    def _integrate_fast(self, stepper: FusedStepper, tf, dt_max, max_steps):
        """Host adaptive-CFL loop over the fused stepper: the CFL bound is
        recomputed (and read back) every accepted step. With ``update_func``
        the terms are refreshed with the accepted state, then the bound is
        taken, then the step refreshes them per stage (JAX's
        ``_integrate_fast``); they persist in ``self.terms``."""
        P = stepper.pack(self.state.values)
        alpha = self.integrator.cfl
        eps = self._eps(tf)
        terms = self.terms
        while self.t <= tf - eps:
            if max_steps is not None and self.last_nsteps >= max_steps:
                break
            if stepper.has_update:
                cfl_t, terms = stepper.cfl_with_terms(P, self.t, terms)
            else:
                cfl_t = stepper.cfl(P, self.t)
            cfl_dt = self._checked_dt(cfl_t.item())
            dt = min(dt_max, alpha * cfl_dt, tf - self.t)
            if stepper.has_update:
                P, terms = stepper.step_with_terms(P, self.t, dt, terms)
            else:
                P = stepper.step(P, self.t, dt)
            self.t += dt
            self.last_nsteps += 1
        self.terms = terms
        self.state = self.state.with_values(stepper.unpack(P).contiguous())
        self._check_finite()
        if self.t > tf - eps:
            self.t = tf
        self.last_fast_path = "fused"
        return self

    def _integrate_band(self, stepper, tf, dt_max, max_steps):
        """Host adaptive-CFL loop over the band stepper. One read-back per
        step brings the CFL bound and the dispatch-list count; a list that
        has overflowed is regrown before the band is stepped, so no update
        is lost. The band is re-tubed on the stepper's cadence and always on
        the step that lands on ``tf``."""
        state = stepper.pack(self.state)
        alpha = self.integrator.cfl
        eps = self._eps(tf)
        while self.t <= tf - eps:
            if max_steps is not None and self.last_nsteps >= max_steps:
                break
            while True:
                dt_t, count_t = stepper.cfl(state, self.t)
                cfl_dt, count = torch.stack([dt_t.double(), count_t.double()]).tolist()
                if count <= stepper.capacity:
                    break
                stepper, state = stepper.regrow(state)
            dt = min(dt_max, alpha * self._checked_dt(cfl_dt), tf - self.t)
            retube = ((self.last_nsteps + 1) % stepper.retube_every == 0
                      or self.t + dt > tf - eps)
            state = stepper.step(state, self.t, dt, retube)
            self.t += dt
            self.last_nsteps += 1
        # every step above ran with a list that fit, so nothing to warn about
        self.state = stepper.unpack(state, check=False)
        self._check_finite()
        if self.t > tf - eps:
            self.t = tf
        self.last_fast_path = "band"
        return self

    def _integrate_general(self, tf, dt_max, prehook, posthook, max_steps):
        """Host loop over the general path (``rhs`` + RK stages), re-tubing a
        band field after every step. As in JAX, a run without hooks raises on
        a non-finite state and a hooked run returns it as it is."""
        alpha = self.integrator.cfl
        eps = self._eps(tf)
        while self.t <= tf - eps:
            if max_steps is not None and self.last_nsteps >= max_steps:
                break
            if prehook is not None:
                prehook(self)
            self.terms = update_terms(self.terms, self.state, self.t)
            cfl_dt = self._checked_dt(_compute_cfl(self.terms, self.state, self.t).item())
            dt = min(dt_max, alpha * cfl_dt, tf - self.t)
            self.state, self.terms = _loop.step(
                self.integrator, self.terms, self.state, self.t, dt)
            self.state = self.state.update_band()  # a no-op on a dense field
            self.t += dt
            self.last_nsteps += 1
            if posthook is not None:
                posthook(self)
        if prehook is None and posthook is None:
            self._check_finite()
        if self.t > tf - eps:
            self.t = tf
        return self

    def __repr__(self):
        term_strs = " + ".join(type(t).__name__ for t in self.terms)
        return (
            "LevelSetEquation:\n"
            f"  |- phi_t + {term_strs} = 0\n"
            f"  |- integrator: {self.integrator.describe()}\n"
            f"  |- t: {self.t}\n"
            f"  |- state: {self.state.shape} {dtype_str(self.state.dtype)}\n"
            f"  `- device: {self.state.device}"
        )
