"""Fused evolution on the persistent padded layout (port of
:mod:`lsm_tpu.integrators.fused`).

The level set lives in the padded buffer between steps; each RK stage is one
K1 pass (:func:`~lsm_tpu_torch.ops.weno_v2.fused_stage`) plus one K2 shell
refresh (:func:`~lsm_tpu_torch.ops.weno_v2.refresh_ghosts_fast`), wrapped in
:func:`~lsm_tpu_torch.ops.weno_v2.fused_step_stage` so that a step is
differentiable (backward: K4, K3 or K3', K5). On CUDA tensors those are the
hand-written kernels; on CPU tensors their plain versions, which drive the
same control flow. One stepper serves ``integrate`` and ``rollout``.

The stepper covers dense 3D and 2D fields under any list of up to 16 terms
of the fused stage's kinds: WENO5 :class:`AdvectionTerm`,
:class:`NormalMotionTerm` (both with or without ``update_func``),
:class:`CurvatureTerm` and :class:`EikonalReinitializationTerm`. A
coefficient is a ``MeshField`` or tensor (streamed), a number (a constant of
the kernel) or a callable ``f(xs, t)``. A callable that follows
:mod:`~lsm_tpu_torch.ops.coef_program`'s rule is traced once, at
construction, into a program the kernels evaluate per node (K1″, K3″):
nothing is streamed for it. Any other callable is evaluated into streamed
tensors at each stage time, at the kernel's node coordinates ``lo + i*h``.
:attr:`FusedStepper.routes` says which route each term took, and why;
:attr:`FusedStepper.stage_route` which kernel a stage launches. A
gradient runs K4, K3 (one advection term) or K3' (any other list) and K5; a
2D field's runs their 2D entries (on the CPU, their plain versions).

``update_func`` (counterpart of JAX's ``_stage_specs`` /
``step_with_terms`` / ``cfl_with_terms``): :meth:`FusedStepper.
step_with_terms` refreshes the terms with each stage's input state and time
and rebuilds their entries (an updated callable is traced again), and
:meth:`FusedStepper.cfl_with_terms` refreshes them with the accepted state
before the CFL bound, as the reference's loop does.

A 2D field lives in its own ``(n0+6, n1+6)`` buffer, packed with its own
boundary conditions (the 2D band's layout), and each stage is K1's and K2's
2D entries. JAX rides its 3D kernels as ``(1, n0, n1)`` (the dummy axis 0
with ``Extrapolation(0)`` ghosts, copies of its one node, so every
difference along it is exactly zero and each 3D Hamiltonian reduces to its
2D form); the 2D entries compute that function with the dummy axis compiled
out. The term list keeps streamed coefficients 2D (an advection velocity
its two components); a callable is traced as the embedding's program, which
sees ``(xs[1], xs[2])`` (:func:`term_entries`), evaluated at coordinate 0
and the field's smallest spacing on the dummy axis (``min(spacing)``, which
the eikonal kind's smoothing reads, stays the field's). The CFL bound is
taken on the 2D field and terms.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import bc as _bc
from ..core.field import MeshField
from ..ops import coef_program as cp
from ..ops import weno_v2 as v2
from ..terms.terms import (AdvectionTerm, CurvatureTerm, EikonalReinitializationTerm,
                           NormalMotionTerm, compute_cfl, is_number, update_terms)
from .explicit import RK2, RK3, ForwardEuler

__all__ = ["FusedStepper", "supports_fused", "unsupported_reason", "term_entry",
           "gradient_reason"]

# (alpha, beta, gamma / dt, stage-time offset / dt) per stage, SSP form; the
# aux buffer of every stage after the first is the step's input state
_STAGES = {
    ForwardEuler: ((0.0, 1.0, 1.0, 0.0),),
    RK2: ((0.0, 1.0, 1.0, 0.0), (0.5, 0.5, 0.5, 1.0)),
    RK3: ((0.0, 1.0, 1.0, 0.0), (0.75, 0.25, 0.25, 1.0),
          (1.0 / 3.0, 2.0 * (1.0 / 3.0), 2.0 * (1.0 / 3.0), 0.5)),
}


def _coef_entry(kind: str, coef, phi: MeshField, k: int):
    """``(TermSpec, streams)`` for a coefficient of ``k`` components (3 for
    a velocity, 1 for a scalar), or the reason it is not a kernel input."""
    what = "an advection velocity" if k > 1 else f"a {kind} coefficient"
    if isinstance(coef, MeshField):
        vals = coef.values
        if k > 1 and (not coef.is_vector or vals.shape[0] != k):
            return f"{what} MeshField must be a {k}-component vector field"
        if k == 1 and tuple(vals.shape) != tuple(phi.shape):
            return f"{what} MeshField must be a scalar field on the level set's grid"
        return (v2.TermSpec(kind, "stream", None, k),
                tuple(vals[d] for d in range(k)) if k > 1 else (vals,))
    if callable(coef):
        return _callable_spec(kind, coef, phi.ndim, k), ()
    if is_number(coef) and k == 1:
        return v2.TermSpec(kind, "const", float(coef), 0), ()
    if isinstance(coef, torch.Tensor):
        if k > 1:
            if tuple(coef.shape) != (k, *phi.shape):
                return (f"{what} tensor must have shape "
                        f"({k}, {', '.join(map(str, phi.shape))})")
            return v2.TermSpec(kind, "stream", None, k), tuple(coef[d] for d in range(k))
        try:
            return v2.TermSpec(kind, "stream", None, 1), (torch.broadcast_to(coef, phi.shape),)
        except RuntimeError:
            return f"{what} tensor must broadcast to the grid's shape {tuple(phi.shape)}"
    return f"{what} of type {type(coef).__name__} is not supported"


def _callable_spec(kind: str, fn, ndim: int, k: int) -> v2.TermSpec:
    """A callable coefficient's spec: a ``"program"`` when it traces on the
    3D node coordinates, else ``"analytic"`` (the stream route) with the
    reason. A 2D field's callable stays untraced here: the embedding wraps
    it first (:func:`_embed_entries_2d`)."""
    if ndim != 3:
        return v2.TermSpec(kind, "analytic", fn, 0)
    prog = cp.trace(fn, 3, k)
    if isinstance(prog, str):
        return v2.TermSpec(kind, "analytic", fn, 0, reason=prog)
    return v2.TermSpec(kind, "program", prog, 0)


def _fit_programs(entries):
    """Entries whose programs fit the kernels' tables together; a program
    that would overflow them takes the stream route instead."""
    ops = consts = tabs = 0
    out = []
    for spec, arrs in entries:
        if spec.coef_kind == "program":
            prog = spec.coef_static
            if (ops + prog.n_ops > cp.MAX_OPS or consts + prog.n_consts > cp.MAX_CONSTS
                    or tabs + len(prog.tables) > cp.MAX_TABLES):
                spec = v2.TermSpec(spec.kind, "analytic", prog.fn, 0,
                                   reason="the stage's other programs fill the kernels' tables")
            else:
                ops, consts = ops + prog.n_ops, consts + prog.n_consts
                tabs += len(prog.tables)
        out.append((spec, arrs))
    return tuple(out)


def term_entry(term, phi: MeshField):
    """``(TermSpec, streams)`` of one term for the fused stage (a callable
    coefficient traced into a program, or kept for the stream route), or the
    reason why the fused path cannot take it (counterpart of
    ``lsm_tpu.integrators.fused._term_spec`` with ``allow_update``)."""
    if isinstance(term, AdvectionTerm):
        if term.scheme != "weno5":
            return f"the {term.scheme!r} advection scheme takes the general path"
        return _coef_entry("advection", term.velocity, phi, phi.ndim)
    if isinstance(term, NormalMotionTerm):
        return _coef_entry("normal", term.speed, phi, 1)
    if isinstance(term, CurvatureTerm):
        return _coef_entry("curvature", term.b, phi, 1)
    if isinstance(term, EikonalReinitializationTerm):
        if term.s0 is None:
            return v2.TermSpec("eikonal", "none", None, 0), ()
        return _coef_entry("eikonal", term.s0, phi, 1)
    return (f"{type(term).__name__}, which is no term kind of the fused stage, takes the "
            "general path")


def unsupported_reason(terms, phi: MeshField, integrator) -> Optional[str]:
    """Why ``(terms, phi, integrator)`` cannot take the fused stepper;
    ``None`` when it can."""
    if phi.active_mask is not None:
        return ("the dense fused stepper takes dense fields only; a NarrowBandField "
                "goes to the band stepper")
    if phi.ndim not in (2, 3):
        return f"the fused stepper takes 2D and 3D fields, not {phi.ndim}D"
    reason = _kind_reason(phi, integrator)
    if reason is None:
        reason = _axes_reason(phi.shape, phi.bcs)
    return reason or _terms_reason(terms, phi)


def _terms_reason(terms, phi: MeshField) -> Optional[str]:
    """The term-list check the dense and the band stepper share: every term
    a kind of the fused stage (WENO5 advection, normal motion, curvature,
    eikonal reinitialization) with a coefficient the stage takes, at most
    ``MAX_TERMS`` of them."""
    if not isinstance(terms, (tuple, list)):
        terms = (terms,)
    if not 1 <= len(terms) <= v2.MAX_TERMS:
        return f"the fused stage takes 1 to {v2.MAX_TERMS} terms, got {len(terms)}"
    for term in terms:
        entry = term_entry(term, phi)
        if isinstance(entry, str):
            return entry
    return None


def _kind_reason(phi: MeshField, integrator) -> Optional[str]:
    """A scalar field with boundary conditions, float32 or float64, and
    FE/RK2/RK3."""
    if phi.is_vector or phi.bcs is None:
        return "the fused path needs a scalar field with boundary conditions"
    if phi.dtype not in (torch.float32, torch.float64):
        return f"the fused kernels take float32 or float64, not {phi.dtype}"
    if type(integrator) not in _STAGES:
        return f"the integrator {type(integrator).__name__} takes the general path"
    return None


def _axes_reason(shape, bcs) -> Optional[str]:
    """K2's rule per axis and side: ``Extrapolation(d)`` needs ``n >= d + 1``
    nodes (as in JAX: with fewer the general path raises ``ValueError``),
    Periodic and Symmetry ``n >= 4``."""
    for ax, n in enumerate(shape):
        for b in bcs[ax]:
            if isinstance(b, _bc.Extrapolation):
                if b.degree + 1 > n:
                    return (f"Extrapolation({b.degree}) needs {b.degree + 1} nodes, axis {ax} "
                            f"has {n}")
            elif n < v2.GHOST + 1:
                return (f"axis {ax} has {n} nodes; the ghost refresh needs >= {v2.GHOST + 1} "
                        f"for {b} ghosts")
    return None


def _field_reason(phi: MeshField, integrator) -> Optional[str]:
    """The band stepper's field and integrator check: a 3D or 2D scalar
    field with BCs the kernels take, every axis at least 4 nodes deep,
    FE/RK2/RK3."""
    if phi.ndim not in (2, 3):
        return f"the band stepper takes a 3D or 2D field, not {phi.ndim}D"
    reason = _kind_reason(phi, integrator)
    if reason is None and min(phi.shape) < v2.GHOST + 1:
        return f"the band stepper needs >= {v2.GHOST + 1} nodes per axis, got {phi.shape}"
    return reason or _axes_reason(phi.shape, phi.bcs)


def embed_2d(phi: MeshField):
    """``(shape, bcs, spacing, lo)`` of a 2D field's ``(1, n0, n1)``
    embedding (see the module docstring): the 3D field JAX steps, whose
    function the 2D entries compute."""
    spacing = tuple(float(h) for h in phi.spacing)
    return ((1, *phi.shape), ((_bc.Extrapolation(0), _bc.Extrapolation(0)), *phi.bcs),
            (min(spacing), *spacing), (0.0, *(float(x) for x in phi.grid.lo)))


def _embed_entries_2d(entries):
    """A 2D term list's ``(TermSpec, streams)`` in the embedding: streamed
    tensors gain the leading length-1 axis, an advection velocity a zero
    component 0, and a callable sees the two real coordinates, wrapped
    before it is traced, so its program reads ``(xs[1], xs[2])``
    (counterpart of ``lsm_tpu.integrators.fused._embed_specs_2d``)."""
    out = []
    for spec, arrs in entries:
        if spec.coef_kind == "analytic":
            f2 = spec.coef_static
            if spec.kind == "advection":
                def f3(xs, t, _f=f2):
                    u, v = _f((xs[1], xs[2]), t)
                    return (0.0 * (xs[0] + xs[1] + xs[2]), u, v)
            else:
                def f3(xs, t, _f=f2):
                    return _f((xs[1], xs[2]), t)
            out.append((_callable_spec(spec.kind, f3, 3, v2.n_components(spec.kind)), ()))
        elif spec.coef_kind == "stream":
            arrs3 = tuple(a[None] for a in arrs)
            if spec.kind == "advection":
                arrs3 = (torch.zeros_like(arrs3[0]), *arrs3)
            out.append((v2.TermSpec(spec.kind, "stream", None, len(arrs3)), arrs3))
        else:
            out.append((spec, arrs))
    return tuple(out)


def _entries_2d(entries):
    """A 2D term list for the dense 2D stage: streams stay 2D (an advection
    velocity its two components), and a callable is traced as the
    embedding's program (:func:`_embed_entries_2d`); one that does not trace
    stays a 2D callable, evaluated on the 2D nodes."""
    out = []
    for spec, arrs in entries:
        if spec.coef_kind == "analytic":
            emb = _embed_entries_2d(((spec, arrs),))[0][0]
            spec = emb if emb.coef_kind == "program" else v2.TermSpec(
                spec.kind, "analytic", spec.coef_static, 0, reason=emb.reason)
        out.append((spec, arrs))
    return tuple(out)


def term_entries(terms, phi: MeshField, embed: bool = True):
    """The fused stage's ``(TermSpec, streams)`` of every term, streams
    contiguous in the field's dtype and on its device, programs within the
    kernels' tables (``terms`` passed :func:`_terms_reason`; else
    ``ValueError``). A 2D field's are the ``(1, n0, n1)`` embedding's (the
    2D band's), or with ``embed=False`` the dense 2D stage's
    (:func:`_entries_2d`)."""
    out = []
    for term in terms:
        entry = term_entry(term, phi)
        if isinstance(entry, str):
            raise ValueError(entry)
        spec, arrs = entry
        out.append((spec, tuple(a.to(device=phi.device, dtype=phi.dtype).contiguous()
                                for a in arrs)))
    if phi.ndim == 2:
        out = _embed_entries_2d(out) if embed else _entries_2d(out)
    return _fit_programs(out)


def gradient_reason(terms, phi: MeshField) -> Optional[str]:
    """Why a gradient through the fused stepper of ``terms`` cannot run on
    CUDA; ``None`` when it can: any term list the stepper takes (K4, K3 or
    K3', K5), on a 3D field or a 2D one (their 2D entries), every axis
    K2 takes (an axis of 1-3 nodes under ``Extrapolation``)."""
    terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
    return _terms_reason(terms, phi) or v2.gradient_reason(
        tuple(term_entry(t, phi) for t in terms))


def supports_fused(terms, phi: MeshField, integrator=None) -> bool:
    """Whether ``(terms, phi)`` qualifies for :class:`FusedStepper`."""
    return unsupported_reason(terms, phi, integrator or RK3()) is None


class FusedStepper:
    """Padded-state stepping for ``phi_t + sum_n H_n(phi) = 0``.

    Usage::

        stepper = FusedStepper(terms, phi, integrator)
        P = stepper.pack(phi.values)
        for _ in range(nsteps):
            P = stepper.step(P, t, dt)   # with update_func: step_with_terms
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
        self.dtype, self.device = phi.dtype, phi.device
        self.stages = _STAGES[type(integrator)]
        #: whether a term refreshes itself (``step_with_terms``, ``cfl_with_terms``)
        self.has_update = any(getattr(t, "update_func", None) is not None for t in terms)
        self.entries = term_entries(terms, phi, embed=False)
        self.shape, self.bcs = tuple(phi.shape), phi.bcs  # a 2D field's buffer: (n0+6, n1+6)
        self.spacing = tuple(float(h) for h in phi.spacing)
        self.lo = tuple(float(x) for x in phi.grid.lo)
        self._stage_route = v2.stage_route(self.entries, self.shape)

    def pack(self, values: torch.Tensor) -> torch.Tensor:
        return v2.pack_padded(values, self.bcs)

    def unpack(self, padded: torch.Tensor) -> torch.Tensor:
        return v2.unpack_padded(padded, self.shape)

    @property
    def routes(self):
        """Per term, how its coefficient reaches the kernels and, for a
        callable on the stream route, why: ``(route, reason)`` with route
        ``"program"`` (traced, evaluated in-kernel), ``"stream"``,
        ``"const"`` or ``"none"``."""
        return tuple((spec.route, spec.reason) for spec, _ in self.entries)

    @property
    def stage_route(self) -> str:
        """The kernel a stage of this stepper launches on CUDA, which its
        term table decides (reported by
        :func:`~lsm_tpu_torch.ops.weno_v2.stage_route`): ``"K1 march"``,
        ``"K1'' march"``, ``"K1'' per node"``, ``"K1' march R=3"``,
        ``"K1' march R=2"`` or ``"K1' per node"`` (a program coefficient in
        a term list); on a 2D field ``"K1 2D march"``, ``"K1'' 2D march"``,
        ``"K1'' 2D per node"`` or ``"K1' 2D per node"``."""
        return self._stage_route

    def stage_terms(self, t, entries=None):
        """The stage's term list at time ``t`` (of ``entries``, default the
        stepper's): a callable on the stream route is evaluated into streams
        at the kernel's node coordinates; a program term passes through."""
        entries = self.entries if entries is None else entries
        if all(spec.coef_kind != "analytic" for spec, _ in entries):
            return entries
        xs = v2.node_coords(self.shape, self.spacing, self.lo, self.dtype, self.device)
        return v2.resolve_terms(entries, xs, t, self.shape, self.dtype, self.device,
                                velocity=len(self.shape))

    def stage(self, P, coeffs, t_stage, aux, coeff_values=None, t_value=None, entries=None):
        """One stage: K1 into a fresh buffer, then K2 on its shells; through
        :func:`~lsm_tpu_torch.ops.weno_v2.fused_step_stage`, so gradients
        flow when an input requires them (backward K4, K3, K5). Program
        terms see the stage time ``t_stage`` (``t_value`` its host number)."""
        return v2.fused_step_stage(P, self.stage_terms(t_stage, entries), coeffs, aux, self.bcs,
                                   self.spacing, self.shape, coeff_values,
                                   v2.Where(self.lo, None, t_stage, t_value))

    def _times(self, t, dt, dt_value, entries=None):
        """Host numbers of ``dt`` and ``t`` (the latter read only when a
        program term depends on the time)."""
        dtv = float(dt) if dt_value is None else float(dt_value)
        uses_t = v2.needs_t(self.entries if entries is None else entries) or self.has_update
        tv = (float(t.detach()) if isinstance(t, torch.Tensor) else float(t)) if uses_t else 0.0
        return tv, dtv

    def step(self, P: torch.Tensor, t, dt, dt_value=None) -> torch.Tensor:
        """One accepted step; returns a new padded buffer (``P`` is kept as
        the aux input of the later stages and not modified). ``t`` and ``dt``
        may be tensors (then the stage coefficients and a callable velocity
        carry their gradients); the kernels take ``dt_value`` (default
        ``float(dt)``) as the host number."""
        tv, dtv = self._times(t, dt, dt_value)
        cur = P
        for s, (alpha, beta, g, off) in enumerate(self.stages):
            cur = self.stage(cur, (alpha, beta, g * dt), t + off * dt,
                             None if s == 0 else P, coeff_values=(alpha, beta, g * dtv),
                             t_value=tv + off * dtv)
        return cur

    def _field(self, P) -> MeshField:
        return MeshField(self.unpack(P), self.grid, self.bcs, _normalized=True)

    def step_with_terms(self, P: torch.Tensor, t, dt, terms, dt_value=None):
        """One accepted step for ``update_func`` terms: before each stage the
        terms are refreshed with the stage's input state and time (the
        reference's per-stage ``update_term!``) and their entries rebuilt.
        Returns ``(P_new, terms)`` (counterpart of JAX's
        ``FusedStepper.step_with_terms``)."""
        tv, dtv = self._times(t, dt, dt_value)
        cur = P
        for s, (alpha, beta, g, off) in enumerate(self.stages):
            t_stage = t + off * dt
            field = self._field(cur)
            terms = update_terms(terms, field, t_stage)
            entries = term_entries(terms, field, embed=False)
            cur = self.stage(cur, (alpha, beta, g * dt), t_stage, None if s == 0 else P,
                             coeff_values=(alpha, beta, g * dtv), t_value=tv + off * dtv,
                             entries=entries)
        return cur, terms

    def cfl(self, P: torch.Tensor, t) -> torch.Tensor:
        """Largest stable ``dt`` for the current padded state (0-d tensor):
        the minimum over the terms (a constant coefficient's bound is a host
        number), on the field's own grid and terms (2D for a 2D field)."""
        return compute_cfl(self.terms, self._field(P), t)

    def cfl_with_terms(self, P: torch.Tensor, t, terms):
        """``update_terms`` with the accepted state, then the CFL bound of
        the refreshed terms: ``(dt, terms)`` (the reference's pre-step
        ``update_term!`` and ``compute_cfl``)."""
        field = self._field(P)
        terms = update_terms(terms, field, t)
        return compute_cfl(terms, field, t), terms
