"""Plain PyTorch reference of the level-set step that the benchmark's
configurations state, against which each run's outputs are judged.

It imports neither the program nor JAX: it is a frozen restatement of the
discretisation the configurations name, in the arithmetic order of the
program's plain versions, so that two sound implementations agree to
rounding:

- ghosts: 3 layers a side, axis 0 first, each axis over the extent the
  earlier ones already have (corners compose); ``periodic`` with a shared
  endpoint (period n-1), ``extrapolation`` of degree P from the P+1 nodes
  next to the face;
- advection: WENO5 (Jiang-Shu indicators, weights 0.1/0.6/0.3, epsilon
  ``1e-6 * max v_i^2`` plus the configuration dtype's floor) upwinded by the
  sign of each velocity component; its adjoint is written out by hand
  (``weno_upwind_vjp``), because the mechanical adjoint of the one-division
  weights multiplies a cancelled difference by ``r**2``;
- normal motion: Godunov's scheme on second-order ENO one-sided differences;
- curvature: ``b * kappa * |grad phi|`` from central differences, zero where
  ``|grad phi|^2`` is below the configuration dtype's epsilon;
- TVD RK3 (Shu-Osher), the step ``min(cfl * bound, tf - t)``.

Whatever the program derives (padded states, coordinates, the CFL step) is
worked out here again from the configuration and the inputs. Every pass over
the grid runs in slabs along axis 0, so that a 512^3 state fits with the
reference's temporaries; ``dtype`` is the precision the reference computes
in, ``scheme_dtype`` the configuration's, which fixes the epsilons.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

GHOST = 3
# (alpha, beta, gamma / dt, stage-time offset / dt) of TVD RK3's stages; the
# aux input of the second and third is the step's input state
RK3_STAGES = ((0.0, 1.0, 1.0, 0.0), (0.75, 0.25, 0.25, 1.0),
              (1.0 / 3.0, 2.0 * (1.0 / 3.0), 2.0 * (1.0 / 3.0), 0.5))
# elements of one slab's plane set, the unit the passes over the grid take
SLAB_ELEMS = 1 << 23


@dataclass
class Term:
    """One term: ``kind`` is advection, normal or curvature. ``coef`` is a
    velocity ``f(xs, t) -> (u0, u1, u2)`` for advection; for the others a
    number or a tensor of the grid's shape (a streamed field)."""
    kind: str
    coef: object


@dataclass
class Problem:
    """A configuration as the reference needs it."""
    shape: Tuple[int, int, int]
    lo: Tuple[float, float, float]
    spacing: Tuple[float, float, float]
    bc: Tuple[str, int]  # ("periodic", 0) or ("extrapolation", degree)
    terms: Sequence[Term]
    cfl: float = 0.5
    dtype: torch.dtype = torch.float64
    scheme_dtype: torch.dtype = torch.float32
    device: object = "cpu"
    slab_elems: int = field(default=SLAB_ELEMS)

    def with_dtype(self, dtype) -> "Problem":
        return Problem(self.shape, self.lo, self.spacing, self.bc, self.terms, self.cfl, dtype,
                       self.scheme_dtype, self.device, self.slab_elems)


# -- ghosts ------------------------------------------------------------------------


def extrapolation_weights(width: int, degree: int):
    """``W[g][j]``: weight of the j-th node from the face for the ghost row
    ``g`` (outermost first, at distance ``width - g``), Lagrange in closed
    form."""
    W = []
    for g in range(width):
        k = width - g
        row = []
        for j in range(degree + 1):
            w = 1.0
            for m in range(degree + 1):
                if m != j:
                    w *= (-k - m) / (j - m)
            row.append(w)
        W.append(row)
    return W


def _pad_axis(v: torch.Tensor, axis: int, bc) -> torch.Tensor:
    n = v.shape[axis]
    kind, degree = bc
    if kind == "periodic":
        left = v.narrow(axis, n - 1 - GHOST, GHOST)
        right = v.narrow(axis, 1, GHOST)
    elif kind == "extrapolation":
        W = extrapolation_weights(GHOST, degree)
        rows_l, rows_r = [], []
        for g in range(GHOST):
            acc_l = W[g][0] * v.narrow(axis, 0, 1)
            acc_r = W[GHOST - 1 - g][0] * v.narrow(axis, n - 1, 1)
            for j in range(1, degree + 1):
                acc_l = acc_l + W[g][j] * v.narrow(axis, j, 1)
                acc_r = acc_r + W[GHOST - 1 - g][j] * v.narrow(axis, n - 1 - j, 1)
            rows_l.append(acc_l)
            rows_r.append(acc_r)
        left, right = torch.cat(rows_l, dim=axis), torch.cat(rows_r, dim=axis)
    else:
        raise ValueError(f"unknown boundary condition {kind!r}")
    return torch.cat([left, v, right], dim=axis)


def pad(phi: torch.Tensor, bc) -> torch.Tensor:
    """``phi`` with 3 ghost layers on every side, axis by axis."""
    for ax in range(phi.ndim):
        phi = _pad_axis(phi, ax, bc)
    return phi.contiguous()


def pad_vjp(phi: torch.Tensor, bc, gP: torch.Tensor) -> torch.Tensor:
    """Cotangent of ``phi`` for the cotangent ``gP`` of ``pad(phi)`` (ghost
    cotangents folded onto the nodes they were made from)."""
    with torch.enable_grad():
        x = phi.detach().requires_grad_()
        return torch.autograd.grad(pad(x, bc), x, gP)[0]


# -- stencils on a padded slab ------------------------------------------------------


def _shift(P, offsets, shape):
    return P[tuple(slice(GHOST + o, GHOST + o + n) for o, n in zip(offsets, shape))]


def _axis(axis, k):
    return tuple(k if d == axis else 0 for d in range(3))


def weno_diffs(P, axis, h, shape):
    """The six backward differences ``D- at I-2 .. I+3`` along ``axis``."""
    s = [_shift(P, _axis(axis, k), shape) for k in range(-3, 4)]
    inv_h = 1.0 / h
    return [(s[k + 1] - s[k]) * inv_h for k in range(6)]


def _weno_eps(vmax, scheme_dtype):
    floor = 1.0e-36 if scheme_dtype == torch.float64 else 1.0e-12
    return 1.0e-6 * vmax + floor


def _weno_forward(dm, u, scheme_dtype):
    cond = u > 0
    v1 = torch.where(cond, dm[0], dm[5])
    v2 = torch.where(cond, dm[1], dm[4])
    v3 = torch.where(cond, dm[2], dm[3])
    v4 = torch.where(cond, dm[3], dm[2])
    v5 = torch.where(cond, dm[4], dm[1])
    e2 = v3 - v2
    e3 = v4 - v3
    c1 = e2 - (v2 - v1)
    c2 = e3 - e2
    c3 = (v5 - v4) - e3
    d1 = v3 + 0.5 * e2 + (1.0 / 3.0) * c1
    d2 = v3 + 0.5 * e3 - (1.0 / 6.0) * c2
    d3 = v3 + 0.5 * e3 - (1.0 / 6.0) * c3
    c13 = 13.0 / 12.0
    t1 = c1 + 2.0 * e2
    t2 = e2 + e3
    t3 = c3 - 2.0 * e3
    s1 = c13 * (c1 * c1) + 0.25 * (t1 * t1)
    s2 = c13 * (c2 * c2) + 0.25 * (t2 * t2)
    s3 = c13 * (c3 * c3) + 0.25 * (t3 * t3)
    sq = (v1 * v1, v2 * v2, v3 * v3, v4 * v4, v5 * v5)
    m12 = torch.maximum(sq[0], sq[1])
    m34 = torch.maximum(sq[2], sq[3])
    m14 = torch.maximum(m12, m34)
    vmax = torch.maximum(m14, sq[4])
    r = 1.0 / _weno_eps(vmax, scheme_dtype)
    b1 = s1 * r + 1.0
    b2 = s2 * r + 1.0
    b3 = s3 * r + 1.0
    p1, p2, p3 = b2 * b3, b1 * b3, b1 * b2
    q1, q2, q3 = 0.1 * (p1 * p1), 0.6 * (p2 * p2), 0.3 * (p3 * p3)
    w = 1.0 / (q1 + q2 + q3)
    core = (q1 * d1 + q2 * d2 + q3 * d3) * w
    return locals()


def weno_upwind(dm, u, scheme_dtype=torch.float32):
    """``u * WENO5(phi)`` along one axis, upwinded by the sign of ``u`` (at
    ``u == 0`` the right-biased branch, multiplied by zero)."""
    return u * _weno_forward(dm, u, scheme_dtype)["core"]


def _max_vjp(a, b, ans, gm):
    """Cotangents of ``maximum(a, b)``; an exact tie splits 0.5/0.5."""
    ta, tb = a == ans, b == ans
    return (gm * torch.where(ta, torch.where(tb, 0.5, 1.0), 0.0),
            gm * torch.where(tb, torch.where(ta, 0.5, 1.0), 0.0))


def weno_upwind_vjp(dm, u, g, scheme_dtype=torch.float32):
    """Cotangents of the six differences ``dm`` and of ``u`` for the
    cotangent ``g`` of :func:`weno_upwind`, the forward's chain reversed."""
    f = _weno_forward(dm, u, scheme_dtype)
    cond, core, w, r = f["cond"], f["core"], f["w"], f["r"]
    v1, v2, v3, v4, v5 = f["v1"], f["v2"], f["v3"], f["v4"], f["v5"]
    c1, c2, c3, t1, t2, t3 = f["c1"], f["c2"], f["c3"], f["t1"], f["t2"], f["t3"]
    b1, b2, b3, p1, p2, p3 = f["b1"], f["b2"], f["b3"], f["p1"], f["p2"], f["p3"]
    c13 = f["c13"]
    du = core * g
    wgc = w * (u * g)
    dd1, dd2, dd3 = f["q1"] * wgc, f["q2"] * wgc, f["q3"] * wgc
    dq1, dq2, dq3 = (f["d1"] - core) * wgc, (f["d2"] - core) * wgc, (f["d3"] - core) * wgc
    dp1, dp2, dp3 = 0.2 * p1 * dq1, 1.2 * p2 * dq2, 0.6 * p3 * dq3
    db1 = b3 * dp2 + b2 * dp3
    db2 = b3 * dp1 + b1 * dp3
    db3 = b2 * dp1 + b1 * dp2
    ds1, ds2, ds3 = r * db1, r * db2, r * db3
    dr = f["s1"] * db1 + f["s2"] * db2 + f["s3"] * db3
    dvmax = -1.0e-6 * (r * r) * dr
    sq = f["sq"]
    dm14, dsq5 = _max_vjp(f["m14"], sq[4], f["vmax"], dvmax)
    dm12, dm34 = _max_vjp(f["m12"], f["m34"], f["m14"], dm14)
    dsq1, dsq2 = _max_vjp(sq[0], sq[1], f["m12"], dm12)
    dsq3, dsq4 = _max_vjp(sq[2], sq[3], f["m34"], dm34)
    dv1, dv2, dv3 = 2.0 * v1 * dsq1, 2.0 * v2 * dsq2, 2.0 * v3 * dsq3
    dv4, dv5 = 2.0 * v4 * dsq4, 2.0 * v5 * dsq5
    dc1 = 2.0 * c13 * c1 * ds1 + 0.5 * t1 * ds1
    dc2 = 2.0 * c13 * c2 * ds2
    dc3 = 2.0 * c13 * c3 * ds3 + 0.5 * t3 * ds3
    de2 = 2.0 * (0.5 * t1 * ds1) + 0.5 * t2 * ds2
    de3 = 0.5 * t2 * ds2 - 2.0 * (0.5 * t3 * ds3)
    dv3 = dv3 + dd1 + dd2 + dd3
    de2 = de2 + 0.5 * dd1
    de3 = de3 + 0.5 * (dd2 + dd3)
    dc1 = dc1 + (1.0 / 3.0) * dd1
    dc2 = dc2 - (1.0 / 6.0) * dd2
    dc3 = dc3 - (1.0 / 6.0) * dd3
    de2 = de2 + dc1 - dc2
    de3 = de3 + dc2 - dc3
    dv1 = dv1 + dc1
    dv2 = dv2 - dc1
    dv4 = dv4 - dc3
    dv5 = dv5 + dc3
    dv3 = dv3 + de2 - de3
    dv2 = dv2 - de2
    dv4 = dv4 + de3
    zero = torch.zeros((), dtype=v1.dtype, device=v1.device)
    ddm = (torch.where(cond, dv1, zero), torch.where(cond, dv2, dv5),
           torch.where(cond, dv3, dv4), torch.where(cond, dv4, dv3),
           torch.where(cond, dv5, dv2), torch.where(cond, zero, dv1))
    return ddm, du


def safe_sqrt(x):
    safe = x > 0
    return torch.where(safe, torch.sqrt(torch.where(safe, x, 1.0)), 0.0)


def _pos(x):
    return torch.maximum(x, x.new_zeros(()))


def _neg(x):
    return torch.minimum(x, x.new_zeros(()))


def _minmod(x, y):
    same = x * y > 0.0
    return torch.where(same, torch.where(torch.abs(x) <= torch.abs(y), x, y), 0.0)


def godunov_norms(P, spacing, shape):
    """``(|grad+|, |grad-|)``: Godunov's upwind gradient magnitudes for
    outward and inward motion, on ENO2 one-sided differences."""
    gp2 = 0.0
    gm2 = 0.0
    for ax, h in enumerate(spacing):
        s = {k: _shift(P, _axis(ax, k), shape) for k in (-2, -1, 0, 1, 2)}
        hh = h * h
        c = (s[1] - 2.0 * s[0] + s[-1]) / hh
        d2mm = (s[-2] - 2.0 * s[-1] + s[0]) / hh
        d2pp = (s[0] - 2.0 * s[1] + s[2]) / hh
        A = (s[0] - s[-1]) / h + 0.5 * h * _minmod(d2mm, c)
        B = (s[1] - s[0]) / h - 0.5 * h * _minmod(d2pp, c)
        gp2 = gp2 + _pos(A) ** 2 + _neg(B) ** 2
        gm2 = gm2 + _neg(A) ** 2 + _pos(B) ** 2
    return safe_sqrt(gp2), safe_sqrt(gm2)


def curvature_motion(P, spacing, shape, b, scheme_dtype):
    """``b * kappa * |grad phi|``, kappa the mean curvature from central
    differences (mixed ones from the four edge neighbours), zero where
    ``|grad phi|^2`` is below the configuration dtype's epsilon."""
    grad = [(_shift(P, _axis(d, 1), shape) - _shift(P, _axis(d, -1), shape)) / (2.0 * h)
            for d, h in enumerate(spacing)]
    c = _shift(P, (0, 0, 0), shape)
    H = {}
    for i in range(3):
        hi = spacing[i]
        H[(i, i)] = (_shift(P, _axis(i, 1), shape) - 2.0 * c
                     + _shift(P, _axis(i, -1), shape)) / (hi * hi)
        for j in range(i + 1, 3):
            def two(a, bb, i=i, j=j):
                off = [0, 0, 0]
                off[i] += a
                off[j] += bb
                return _shift(P, tuple(off), shape)
            H[(i, j)] = (two(1, 1) - two(1, -1) - two(-1, 1) + two(-1, -1)) / (
                4.0 * hi * spacing[j])
    nrmsq = 0.0
    for g in grad:
        nrmsq = nrmsq + g * g
    lap = 0.0
    quad = 0.0
    for i in range(3):
        lap = lap + H[(i, i)]
        quad = quad + grad[i] * grad[i] * H[(i, i)]
        for j in range(i + 1, 3):
            quad = quad + 2.0 * grad[i] * grad[j] * H[(i, j)]
    safe = nrmsq >= torch.finfo(scheme_dtype).eps
    nrmsq_safe = torch.where(safe, nrmsq, 1.0)
    kappa = torch.where(safe, (lap * nrmsq_safe - quad) / nrmsq_safe ** 1.5, 0.0)
    return b * kappa * safe_sqrt(nrmsq)


# -- coordinates and coefficients ------------------------------------------------------


def coords(prob: Problem, a: int = 0, b: Optional[int] = None, dtype=None):
    """Broadcastable node coordinates ``lo + i*h`` of axis-0 rows ``a:b``."""
    dtype = dtype or prob.dtype
    b = prob.shape[0] if b is None else b
    out = []
    for d, n in enumerate(prob.shape):
        lo_i, hi_i = (a, b) if d == 0 else (0, n)
        view = [1, 1, 1]
        view[d] = hi_i - lo_i
        i = torch.arange(lo_i, hi_i, dtype=torch.float64, device=prob.device).reshape(view)
        out.append((prob.lo[d] + i * float(prob.spacing[d])).to(dtype))
    return tuple(out)


def _coef_slab(term: Term, prob: Problem, a: int, b: int, t: float, coefs):
    """A term's coefficient on the rows ``a:b``: velocity components,
    ``(value,)`` or the streamed slab (``coefs`` overrides a streamed
    field)."""
    shape = (b - a, prob.shape[1], prob.shape[2])
    if term.kind == "advection":
        comps = term.coef(coords(prob, a, b), t)
        return tuple(torch.broadcast_to(torch.as_tensor(c, dtype=prob.dtype, device=prob.device),
                                        shape) for c in comps)
    c = coefs if coefs is not None else term.coef
    if isinstance(c, torch.Tensor):
        return (c[a:b].to(prob.dtype),)
    return (torch.full((), float(c), dtype=prob.dtype, device=prob.device),)


def moving_axes(u):
    """The axes along which the velocity ``u`` is not zero at every node:
    along the others ``u * WENO5(phi)`` and its adjoint are exactly zero."""
    return [ax for ax, comp in enumerate(u) if bool(torch.any(comp != 0))]


def hamiltonian(Ps, prob: Problem, shape, coefs):
    """``sum_n H_n`` on the interior of the padded slab ``Ps``."""
    ham = 0.0
    for term, coef in zip(prob.terms, coefs):
        if term.kind == "advection":
            adv = 0.0
            for ax in moving_axes(coef):
                adv = adv + weno_upwind(weno_diffs(Ps, ax, float(prob.spacing[ax]), shape),
                                        coef[ax], prob.scheme_dtype)
            ham = ham + adv
        elif term.kind == "normal":
            gp, gm = godunov_norms(Ps, prob.spacing, shape)
            ham = ham + (_pos(coef[0]) * gp + _neg(coef[0]) * gm)
        elif term.kind == "curvature":
            ham = ham + curvature_motion(Ps, prob.spacing, shape, coef[0], prob.scheme_dtype)
        else:
            raise ValueError(f"unknown term kind {term.kind!r}")
    return ham


def slabs(prob: Problem):
    n0, n1, n2 = prob.shape
    step = max(1, prob.slab_elems // ((n1 + 2 * GHOST) * (n2 + 2 * GHOST)))
    for a in range(0, n0, step):
        yield a, min(n0, a + step)


# -- the step -----------------------------------------------------------------------


def stage(phi, aux, coeffs, t, prob: Problem, streams=None):
    """``alpha*aux + beta*phi - gamma*sum_n H_n(phi)`` (``aux`` may be
    ``None``); ``streams`` per term, a streamed coefficient or ``None``."""
    alpha, beta, gamma = coeffs
    streams = streams or [None] * len(prob.terms)
    P = pad(phi, prob.bc)
    out = torch.empty_like(phi)
    for a, b in slabs(prob):
        shape = (b - a, prob.shape[1], prob.shape[2])
        Ps = P[a:b + 2 * GHOST]
        coefs = [_coef_slab(term, prob, a, b, t, s) for term, s in zip(prob.terms, streams)]
        res = beta * _shift(Ps, (0, 0, 0), shape) - gamma * hamiltonian(Ps, prob, shape, coefs)
        if aux is not None:
            res = alpha * aux[a:b] + res
        out[a:b] = res
    return out


def rk3_states(phi, t, dt, prob: Problem, streams=None):
    """One RK3 step: its three stage inputs (the step input first) and the
    step's output, last."""
    states = [phi]
    for s, (alpha, beta, g, off) in enumerate(RK3_STAGES):
        states.append(stage(states[-1], None if s == 0 else phi, (alpha, beta, g * dt),
                            t + off * dt, prob, streams))
    return states


def rk3_step(phi, t, dt, prob: Problem, streams=None):
    return rk3_states(phi, t, dt, prob, streams)[-1]


def cfl_bound(prob: Problem, t: float = 0.0, streams=None) -> float:
    """The largest stable step of the term list at time ``t`` (the minimum
    over the terms), as a host number."""
    streams = streams or [None] * len(prob.terms)
    bound = math.inf
    inv_h = [1.0 / h for h in prob.spacing]
    for term, s in zip(prob.terms, streams):
        if term.kind == "advection":
            m = torch.zeros((), dtype=prob.dtype, device=prob.device)
            for a, b in slabs(prob):
                u = _coef_slab(term, prob, a, b, t, None)
                acc = 0.0
                for comp, ih in zip(u, inv_h):
                    acc = acc + torch.abs(comp) * ih
                m = torch.maximum(m, acc.max())
            bound = min(bound, 1.0 / float(m))
            continue
        c = s if s is not None else term.coef
        mx = float(c.abs().max()) if isinstance(c, torch.Tensor) else abs(float(c))
        if term.kind == "normal":
            bound = min(bound, 1.0 / (mx * sum(inv_h)))
        else:
            hmin = min(prob.spacing)
            bound = min(bound, hmin * hmin / (2.0 * mx))
    return bound


def as_dtype(x: float, dtype) -> float:
    """``x`` as ``dtype`` holds it."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def integrate(phi, t0: float, tf: float, max_steps: int, prob: Problem):
    """The adaptive host loop: ``(phi, t, steps)`` after at most
    ``max_steps`` RK3 steps of ``min(cfl * bound, tf - t)``, stopping at
    ``tf`` (the configuration dtype's epsilon, scaled by ``tf``). The step,
    and the time it advances, are the step as the computing dtype holds it,
    as a program computing in that dtype advances."""
    eps = torch.finfo(prob.scheme_dtype).eps * max(abs(tf), 1.0)
    t, steps = float(t0), 0
    phi = phi.to(prob.dtype)
    while t <= tf - eps and steps < max_steps:
        dt = as_dtype(min(prob.cfl * cfl_bound(prob, t), tf - t), prob.dtype)
        phi = rk3_step(phi, t, dt, prob)
        t += dt
        steps += 1
    return phi, t, steps


# -- the gradient -----------------------------------------------------------------------


def stage_vjp(phi, has_aux, coeffs, t, prob: Problem, g, streams):
    """Cotangents ``(g_phi, g_aux, g_streams)`` of :func:`stage` for the
    cotangent ``g`` of its output, slab by slab: advection by the hand
    adjoint, the other terms by autograd of their plain Hamiltonian."""
    alpha, beta, gamma = coeffs
    P = pad(phi, prob.bc)
    gP = torch.zeros_like(P)
    g_streams = [None if s is None else torch.zeros_like(s, dtype=prob.dtype) for s in streams]
    for a, b in slabs(prob):
        shape = (b - a, prob.shape[1], prob.shape[2])
        Ps = P[a:b + 2 * GHOST]
        gPs = gP[a:b + 2 * GHOST]
        gs = g[a:b]
        _shift(gPs, (0, 0, 0), shape).add_(beta * gs)
        gH = -gamma * gs
        others = []
        for k, (term, s) in enumerate(zip(prob.terms, streams)):
            if term.kind != "advection":
                others.append((k, term, s))
                continue
            u = _coef_slab(term, prob, a, b, t, None)
            for ax in moving_axes(u):
                h = float(prob.spacing[ax])
                inv_h = 1.0 / h
                ddm, _ = weno_upwind_vjp(weno_diffs(Ps, ax, h, shape), u[ax], gH,
                                         prob.scheme_dtype)
                for k6 in range(6):
                    _shift(gPs, _axis(ax, k6 - 2), shape).add_(ddm[k6] * inv_h)
                    _shift(gPs, _axis(ax, k6 - 3), shape).sub_(ddm[k6] * inv_h)
        if others:
            with torch.enable_grad():
                Pv = Ps.detach().requires_grad_()
                leaves, coefs = [], []
                for k, term in enumerate(prob.terms):
                    if term.kind == "advection":
                        coefs.append(None)
                        continue
                    c = _coef_slab(term, prob, a, b, t, streams[k])
                    if streams[k] is not None:
                        c = (c[0].detach().requires_grad_(),)
                        leaves.append((k, c[0]))
                    coefs.append(c)
                sub = Problem(prob.shape, prob.lo, prob.spacing, prob.bc,
                              [term for term in prob.terms if term.kind != "advection"],
                              prob.cfl, prob.dtype, prob.scheme_dtype, prob.device)
                H = hamiltonian(Pv, sub, shape, [c for c in coefs if c is not None])
                grads = torch.autograd.grad(H, [Pv] + [x for _, x in leaves], gH)
            gPs.add_(grads[0])
            for (k, _), gk in zip(leaves, grads[1:]):
                g_streams[k][a:b] += gk
    g_phi = pad_vjp(phi, prob.bc, gP)
    return g_phi, (alpha * g if has_aux else None), g_streams


def rollout(phi0, dt: float, nsteps: int, prob: Problem, streams=None, t0: float = 0.0):
    """``nsteps`` RK3 steps of the fixed ``dt``; returns each step's stage
    inputs (the step input first) and the final state."""
    stages = []
    phi = phi0.to(prob.dtype)
    for k in range(nsteps):
        states = rk3_states(phi, t0 + k * dt, dt, prob, streams)
        phi = states.pop()
        stages.append(states)
    return stages, phi


def rollout_grad(phi0, dt: float, nsteps: int, prob: Problem, streams=None, t0: float = 0.0):
    """``L = sum(phi(T)^2)`` over the nodes, after ``nsteps`` RK3 steps of
    ``dt`` from ``phi0``, and its cotangents w.r.t. ``phi0`` and each
    streamed coefficient: ``(L, g_phi0, g_streams)``. The forward sweep
    keeps every stage's input for the reverse sweep."""
    streams = [None if s is None else s.to(prob.dtype) for s in
               (streams or [None] * len(prob.terms))]
    stages, phiT = rollout(phi0, dt, nsteps, prob, streams, t0)
    loss = float((phiT.double() ** 2).sum())
    g = 2.0 * phiT
    del phiT
    g_total = [None if s is None else torch.zeros_like(s) for s in streams]
    for k in range(nsteps - 1, -1, -1):
        t = t0 + k * dt
        states = stages.pop()
        x = states[0]
        g_x = torch.zeros_like(x)
        for s in range(len(RK3_STAGES) - 1, -1, -1):
            alpha, beta, gg, off = RK3_STAGES[s]
            g, g_aux, g_s = stage_vjp(states[s], s > 0, (alpha, beta, gg * dt),
                                      t + off * dt, prob, g, streams)
            if g_aux is not None:
                g_x += g_aux
            for acc, gk in zip(g_total, g_s):
                if acc is not None:
                    acc += gk
        g = g + g_x
        del states, x
    return loss, g, g_total
