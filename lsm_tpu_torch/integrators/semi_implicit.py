"""Semi-implicit I2OE advection integrator (Mikula et al.), matrix-free (port
of :mod:`lsm_tpu.integrators.semi_implicit`).

The inflow part of each face flux is implicit, the outflow part explicit,
which keeps the scheme stable at CFL >> 1 (default safety factor 2.0 against
0.5 explicit). The linear system of a step is applied matrix-free as the
stencil operator

    A(u) = u + fac * sum_faces a_in * (u - u_nb(u))

where ``u_nb`` is the ghost-linear neighbour map (a one-layer BC pad), and
solved by BiCGStab with a Jacobi preconditioner: plain torch on the field's
device (JAX's step is XLA too; no TPU kernel runs it). :func:`bicgstab`
repeats ``jax.scipy.sparse.linalg.bicgstab``'s recurrences step for step
(its tolerance rule, loop test, early exit and breakdown codes), reading the
loop test back to the host once an iteration. The solve is differentiable as
``lax.custom_linear_solve`` is: the backward solves ``A^T lam = g`` with the
same BiCGStab and returns ``lam`` for the right-hand side and ``-lam . dA/dtheta
x`` for the face coefficients (and ``dt``), so the velocity gets a gradient.

Face velocities average the two adjacent nodes, degrading to the node value
at Extrapolation boundaries through a clamp pad. Supported BCs: Periodic,
Neumann (``Extrapolation(0)``) and LinearExtrapolation
(``Extrapolation(1)``); others raise, as does a narrow band. A
``ShardedField`` raises ``TypeError``: the implicit solve couples every node
of the grid, and a per-shard solve would be a different (wrong) result.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from ..core.bc import Extrapolation, Periodic, pad_ghost
from ..core.field import MeshField
from ..ops import stencils as st
from ..terms.terms import AdvectionTerm, _eval_vector_field, update_terms
from .explicit import TimeIntegrator

__all__ = ["SemiImplicitI2OE", "bicgstab"]


def _check_setup(terms, phi):
    if getattr(phi, "is_sharded", False):
        raise TypeError("SemiImplicitI2OE takes a MeshField on one device, not a ShardedField: "
                        "its implicit solve couples the whole grid")
    if len(terms) != 1 or not isinstance(terms[0], AdvectionTerm):
        raise ValueError("SemiImplicitI2OE requires exactly one AdvectionTerm")
    if phi.active_mask is not None:
        raise ValueError("SemiImplicitI2OE requires a full-grid MeshField, not a narrow band")
    if any(n < 3 for n in phi.shape):
        raise ValueError("SemiImplicitI2OE requires at least 3 grid nodes along each dimension")
    for pair in phi.bcs:
        for b in pair:
            if not (isinstance(b, Periodic) or (isinstance(b, Extrapolation)
                                                and b.degree in (0, 1))):
                raise ValueError(f"boundary condition {b} is not supported by SemiImplicitI2OE")


def _clamp_pad(v: torch.Tensor, bcs, width: int = 1) -> torch.Tensor:
    """Pad with Periodic kept and Extrapolation degraded to a clamp (Neumann):
    the face-velocity rule at extrapolation boundaries."""
    clamped = tuple(tuple(b if isinstance(b, Periodic) else Extrapolation(0) for b in pair)
                    for pair in bcs)
    return pad_ghost(v, clamped, width)


def _neighbor(padded: torch.Tensor, axis: int, side: int, shape) -> torch.Tensor:
    off = tuple(side if d == axis else 0 for d in range(len(shape)))
    return st.shift(padded, off, 1, shape)


def bicgstab(A, b: torch.Tensor, x0: torch.Tensor, tol: float, maxiter: int, M=None,
             atol: float = 0.0):
    """Preconditioned BiCGStab on flat tensors, with the recurrences of
    ``jax.scipy.sparse.linalg.bicgstab`` (``_bicgstab_solve``): stop when
    ``|r|^2 <= max(tol^2 |b|^2, atol^2)``, after ``maxiter`` iterations, or on
    a breakdown (``rho == 0``: code -10; ``omega == 0`` or ``alpha == 0``:
    -11). Returns ``(x, k)``, ``k`` the iterations run (or the breakdown
    code). One host read an iteration: the loop test."""
    M = M if M is not None else (lambda v: v)
    atol2 = torch.clamp(tol ** 2 * torch.dot(b, b), min=atol ** 2)
    r = b - A(x0)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    x, rhat, alpha, omega, rho, p, q = x0, r, one, one, one, r, r
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    while bool((torch.dot(r, r) > atol2) & (k < maxiter) & (k >= 0)):
        rho_ = torch.dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        phat = M(p_)
        q_ = A(phat)
        alpha_ = rho_ / torch.dot(rhat, q_)
        s = r - alpha_ * q_
        exit_early = torch.dot(s, s) < atol2
        shat = M(s)
        t = A(shat)
        omega_ = torch.dot(t, s) / torch.dot(t, t)
        x = torch.where(exit_early, x + alpha_ * phat, x + (alpha_ * phat + omega_ * shat))
        r = torch.where(exit_early, s, s - omega_ * t)
        k = torch.where((omega_ == 0) | (alpha_ == 0), -11, k + 1)
        k = torch.where(rho_ == 0, -10, k).to(torch.int32)
        alpha, omega, rho, p, q = alpha_, omega_, rho_, p_, q_
    return x, int(k)


class _LinearSolve(torch.autograd.Function):
    """``x = A^{-1} b`` by :func:`bicgstab`, differentiable in ``b`` and in
    the operator's parameters as ``lax.custom_linear_solve``: backward solves
    ``A^T lam = g`` (``A^T`` the VJP of the linear ``A``) from the same
    initial guess, tolerance and preconditioner."""

    @staticmethod
    def forward(ctx, spec, b, *params):
        ctx.spec = spec
        with torch.no_grad():
            x, k = bicgstab(lambda u: spec["A"](u, params), b, spec["x0"], spec["tol"],
                            spec["maxiter"], spec["M"])
        spec["iterations"] = k
        ctx.save_for_backward(x, *params)
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        spec = ctx.spec
        fixed = [p.detach() for p in params]
        with torch.enable_grad():
            z = torch.zeros_like(g, requires_grad=True)
            Az = spec["A"](z, fixed)
        AT = lambda v: torch.autograd.grad(Az, z, v, retain_graph=True)[0]
        lam, k = bicgstab(AT, g, spec["x0"], spec["tol"], spec["maxiter"], spec["M"])
        spec["iterations_transpose"] = k
        need = [i for i in range(len(params)) if ctx.needs_input_grad[2 + i]]
        grads = [None] * len(params)
        if need:
            with torch.enable_grad():
                ps = [p.requires_grad_() if i in need else p for i, p in
                      enumerate(p.detach() for p in params)]
                gs = torch.autograd.grad(spec["A"](x, ps), [ps[i] for i in need], lam)
            for i, gi in zip(need, gs):
                grads[i] = -gi
        return (None, lam, *grads)


def _warn_nonconverged(rel_resid, tol):
    warnings.warn(
        f"SemiImplicitI2OE: BiCGStab did not converge (relative residual "
        f"{float(rel_resid):.3e} > tol {float(tol):.3e}); the step uses the "
        "best-effort iterate")


@dataclasses.dataclass(frozen=True, repr=False)
class SemiImplicitI2OE(TimeIntegrator):
    """Semi-implicit advection (stable at CFL >> 1). ``tol``/``maxiter``
    control the BiCGStab solve of the per-step linear system.

    ``tol=None`` (default) resolves to ``50 * eps(dtype)``. The solve is
    Jacobi-preconditioned with the exact system diagonal ``1 + fac *
    sum(a_in)``, and a post-solve residual check warns (without failing)
    when the returned iterate did not reach ``10 * tol``. After each step
    ``last_solve`` holds ``{"iterations", "rel_residual", "tol"}`` of its
    solve (``iterations`` the BiCGStab count, or a breakdown code)."""

    cfl: float = 2.0
    tol: Optional[float] = None
    maxiter: int = 500
    precondition: bool = True
    check_convergence: bool = True

    def advance(self, terms, phi: MeshField, t, dt, dt_value=None):
        _check_setup(terms, phi)
        terms = update_terms(terms, phi, t)
        term = terms[0]
        shape, ndim, spacing = phi.shape, phi.ndim, phi.spacing
        cell_vol = phi.grid.cell_volume
        fac = dt / (2.0 * cell_vol)

        u_old = phi.values
        vel = _eval_vector_field(term.velocity, phi, t)
        # inflow / outflow face coefficients per dimension and side
        ain = []
        aout_flux = 0.0
        u_old_pad = phi.pad(1)
        for d in range(ndim):
            area = cell_vol / spacing[d]
            v_pad = _clamp_pad(vel[d], phi.bcs)
            for side, sign in ((-1, 1.0), (1, -1.0)):
                vface = 0.5 * (vel[d] + _neighbor(v_pad, d, side, shape))
                a = sign * area * vface
                ain.append(torch.clamp(a, min=0.0))
                a_out = torch.clamp(a, max=0.0)
                u_nb_old = _neighbor(u_old_pad, d, side, shape)
                # explicit outflow: rhs -= fac * aout * (u_old - u_nb_old)
                aout_flux = aout_flux - a_out * (u_old - u_nb_old)
        rhs = u_old + fac * aout_flux
        bcs = phi.bcs

        def A(u, params):
            *a_in, f = params
            u = u.reshape(shape)
            u_pad = pad_ghost(u, bcs, 1)
            acc = u
            k = 0
            for d in range(ndim):
                for side in (-1, 1):
                    acc = acc + f * a_in[k] * (u - _neighbor(u_pad, d, side, shape))
                    k += 1
            return acc.reshape(-1)

        tol = self.tol if self.tol is not None else 50.0 * float(torch.finfo(u_old.dtype).eps)
        M = None
        if self.precondition:
            # Jacobi: the system diagonal is exactly 1 + fac * sum_faces a_in
            inv_diag = (1.0 / (1.0 + fac * sum(ain))).detach().reshape(-1)
            M = lambda v: v * inv_diag
        fac_t = fac if isinstance(fac, torch.Tensor) else torch.tensor(
            fac, dtype=u_old.dtype, device=u_old.device)
        spec = {"A": A, "M": M, "x0": u_old.detach().reshape(-1), "tol": tol,
                "maxiter": self.maxiter}
        b = rhs.reshape(-1)
        sol = _LinearSolve.apply(spec, b, *ain, fac_t)
        info = {"iterations": spec["iterations"], "rel_residual": None, "tol": tol}
        if self.check_convergence:
            with torch.no_grad():
                rel = torch.linalg.vector_norm(A(sol, (*ain, fac_t)) - b) / torch.clamp(
                    torch.linalg.vector_norm(b), min=torch.finfo(u_old.dtype).tiny)
            info["rel_residual"] = float(rel)
            if info["rel_residual"] > 10.0 * tol:
                _warn_nonconverged(rel, tol)
        object.__setattr__(self, "last_solve", info)
        return phi.with_values(sol.reshape(shape)), terms

    def describe(self):
        return "SemiImplicitI2OE (semi-implicit advection, Mikula et al.)"
