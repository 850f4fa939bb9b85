"""Whole-array finite-difference, WENO5 and ENO2/Godunov stencils (port of
the parts of :mod:`lsm_tpu.ops.stencils` the fused stage's term kinds need).

Every operator maps a ghost-padded tensor ``p`` (pad width ``g`` on each side
of every spatial axis) to an interior-shaped tensor, as shifted slices. These
plain versions are the oracle the CUDA stage kernel is held against, so the
arithmetic order follows the JAX helpers term by term.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = [
    "PAD_D0",
    "PAD_ENO2",
    "PAD_WENO5",
    "shift",
    "d0",
    "dp",
    "dm",
    "weno5_pair_diffs",
    "weno5m",
    "weno5p",
    "weno5_pair",
    "weno5_upwind",
    "weno5_upwind_fwd_bwd",
    "safe_sqrt",
    "d2c",
    "d2pp",
    "d2mm",
    "d2_mixed",
    "minmod",
    "eno2_onesided",
    "godunov_norms",
    "pos",
    "neg",
]

PAD_D0 = 1
PAD_ENO2 = 2
PAD_WENO5 = 3


def shift(p: torch.Tensor, offsets, g, shape: Sequence[int]) -> torch.Tensor:
    """Interior-shaped view ``phi[I + offsets]`` of a padded tensor.

    ``g`` is the ghost width, an int or one per spatial axis. Leading
    (component) axes of ``p`` beyond ``len(shape)`` pass through.
    """
    nspatial = len(shape)
    lead = p.ndim - nspatial
    gs = (g,) * nspatial if isinstance(g, int) else tuple(g)
    sl = [slice(None)] * lead
    for d in range(nspatial):
        off = gs[d] + offsets[d]
        sl.append(slice(off, off + shape[d]))
    return p[tuple(sl)]


def _axis_offset(axis: int, k: int, ndim: int) -> Tuple[int, ...]:
    return tuple(k if d == axis else 0 for d in range(ndim))


def _s(p, axis, k, g, shape):
    return shift(p, _axis_offset(axis, k, len(shape)), g, shape)


def d0(p, axis, h, g, shape):
    """Centered first derivative along ``axis``."""
    return (_s(p, axis, 1, g, shape) - _s(p, axis, -1, g, shape)) / (2.0 * h)


def dp(p, axis, h, g, shape):
    """Forward first derivative along ``axis``."""
    return (_s(p, axis, 1, g, shape) - _s(p, axis, 0, g, shape)) / h


def dm(p, axis, h, g, shape):
    """Backward first derivative along ``axis``."""
    return (_s(p, axis, 0, g, shape) - _s(p, axis, -1, g, shape)) / h


def _weno_core(v1, v2, v3, v4, v5):
    """Classic fifth-order WENO reconstruction from five one-sided differences
    ordered from the upwind end inward (Jiang-Shu smoothness indicators,
    weights 0.1/0.6/0.3, fudge factor ``1e-6 * max(v_i^2)`` plus a floor in
    the working dtype, as :func:`_weno_eps`)."""
    d1 = (1.0 / 3.0) * v1 - (7.0 / 6.0) * v2 + (11.0 / 6.0) * v3
    d2 = -(1.0 / 6.0) * v2 + (5.0 / 6.0) * v3 + (1.0 / 3.0) * v4
    d3 = (1.0 / 3.0) * v3 + (5.0 / 6.0) * v4 - (1.0 / 6.0) * v5
    s1 = (13.0 / 12.0) * (v1 - 2.0 * v2 + v3) ** 2 + 0.25 * (v1 - 4.0 * v2 + 3.0 * v3) ** 2
    s2 = (13.0 / 12.0) * (v2 - 2.0 * v3 + v4) ** 2 + 0.25 * (v2 - v4) ** 2
    s3 = (13.0 / 12.0) * (v3 - 2.0 * v4 + v5) ** 2 + 0.25 * (3.0 * v3 - 4.0 * v4 + v5) ** 2
    vmax = torch.maximum(torch.maximum(torch.maximum(v1 * v1, v2 * v2),
                                       torch.maximum(v3 * v3, v4 * v4)), v5 * v5)
    floor = 1.0e-36 if v1.dtype == torch.float64 else 1.0e-12
    eps = 1.0e-6 * vmax + floor
    a1 = 0.1 / (s1 + eps) ** 2
    a2 = 0.6 / (s2 + eps) ** 2
    a3 = 0.3 / (s3 + eps) ** 2
    inv = 1.0 / (a1 + a2 + a3)
    return (a1 * d1 + a2 * d2 + a3 * d3) * inv


def weno5m(p, axis, h, g, shape):
    """Left-biased fifth-order WENO derivative along ``axis`` (``weno5-``),
    from the five backward differences at ``I-2 .. I+2``; needs ``g >= 3``."""
    s = [_s(p, axis, k, g, shape) for k in range(-3, 3)]  # offsets -3..2
    return _weno_core(*[(s[k + 1] - s[k]) / h for k in range(5)])


def weno5p(p, axis, h, g, shape):
    """Right-biased fifth-order WENO derivative along ``axis`` (``weno5+``),
    from the five forward differences at ``I+2 .. I-2`` (upwind end first)."""
    s = [_s(p, axis, k, g, shape) for k in range(-2, 4)]  # offsets -2..3
    diffs = [(s[k + 1] - s[k]) / h for k in range(5)]  # D+ at I-2..I+2
    return _weno_core(diffs[4], diffs[3], diffs[2], diffs[1], diffs[0])


def _weno_eps(vmax, dtype):
    # absolute floor: keeps a flat stencil (all v_i = 0) away from 0/0 and its
    # eps^-3 gradient terms finite in the working dtype
    floor = 1.0e-36 if dtype == torch.float64 else 1.0e-12
    return 1.0e-6 * vmax + floor


def _weno_combine(s1, s2, s3, eps, d1, d2, d3):
    """Weighted combination with one division plus one shared reciprocal:
    with ``b_i = (s_i+eps)/eps``, ``a_i ∝ g_i (b_j b_k)^2``, so the weights
    ``a_i / sum(a)`` are the classic ones and every intermediate stays in
    fp32 range; a flat stencil gives exact 0.1/0.6/0.3 weights."""
    r = 1.0 / eps
    b1 = s1 * r + 1.0
    b2 = s2 * r + 1.0
    b3 = s3 * r + 1.0
    q1 = 0.1 * (b2 * b3) ** 2
    q2 = 0.6 * (b1 * b3) ** 2
    q3 = 0.3 * (b1 * b2) ** 2
    qsum = q1 + q2 + q3
    w = 1.0 / qsum
    return (q1 * d1 + q2 * d2 + q3 * d3) * w


def weno5_pair(dm):
    """Fused (weno5-, weno5+) from the six shared backward differences ``dm[k]``,
    ``k = -2..3`` relative to node ``I`` (``dm[j] = D- at I + j - 2``), sharing
    the first and second difference tables ``e`` and ``c`` between the two
    biases' Jiang-Shu indicators and using the one-division weight form.
    Identical in exact arithmetic to ``(_weno_core(dm[0..4]),
    _weno_core(dm[5], dm[4], dm[3], dm[2], dm[1]))``; JAX's sums in JAX's
    order. Nothing on the steppers' paths calls it."""
    dtype = dm[0].dtype
    c13 = 13.0 / 12.0
    e = [dm[k + 1] - dm[k] for k in range(5)]
    c = [e[k + 1] - e[k] for k in range(4)]
    c_sq = [ck * ck for ck in c]
    # minus-biased (stencil dm[0..4])
    s1m = c13 * c_sq[0] + 0.25 * (c[0] + 2.0 * e[1]) ** 2
    s2m = c13 * c_sq[1] + 0.25 * (e[1] + e[2]) ** 2
    s3m = c13 * c_sq[2] + 0.25 * (c[2] - 2.0 * e[2]) ** 2
    # plus-biased (stencil dm[5..1], the reflection)
    s1p = c13 * c_sq[3] + 0.25 * (c[3] - 2.0 * e[3]) ** 2
    s2p = c13 * c_sq[2] + 0.25 * (e[2] + e[3]) ** 2
    s3p = c13 * c_sq[1] + 0.25 * (c[1] + 2.0 * e[2]) ** 2
    sq = [v * v for v in dm]
    mid = torch.maximum(torch.maximum(sq[1], sq[2]), torch.maximum(sq[3], sq[4]))  # dm[1..4]
    eps_m = _weno_eps(torch.maximum(mid, sq[0]), dtype)
    eps_p = _weno_eps(torch.maximum(mid, sq[5]), dtype)
    d1m = (1.0 / 3.0) * dm[0] - (7.0 / 6.0) * dm[1] + (11.0 / 6.0) * dm[2]
    d2m = -(1.0 / 6.0) * dm[1] + (5.0 / 6.0) * dm[2] + (1.0 / 3.0) * dm[3]
    d3m = (1.0 / 3.0) * dm[2] + (5.0 / 6.0) * dm[3] - (1.0 / 6.0) * dm[4]
    d1p = (1.0 / 3.0) * dm[5] - (7.0 / 6.0) * dm[4] + (11.0 / 6.0) * dm[3]
    d2p = -(1.0 / 6.0) * dm[4] + (5.0 / 6.0) * dm[3] + (1.0 / 3.0) * dm[2]
    d3p = (1.0 / 3.0) * dm[3] + (5.0 / 6.0) * dm[2] - (1.0 / 6.0) * dm[1]
    minus = _weno_combine(s1m, s2m, s3m, eps_m, d1m, d2m, d3m)
    plus = _weno_combine(s1p, s2p, s3p, eps_p, d1p, d2p, d3p)
    return minus, plus


def weno5_upwind(dm, u):
    """Upwinded WENO5 advection contribution ``u * (u>0 ? weno5- : weno5+)``
    along one axis, from the six backward differences ``dm`` (see
    :func:`weno5_pair_diffs`) and that axis's velocity ``u``.

    The five stencil inputs are selected by the sign of ``u`` and one core
    runs (the plus-biased core is the minus core on the reflected stencil).
    At ``u == 0`` the plus branch is taken and multiplied by zero.
    """
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
    t1 = c1 + 2.0 * e2  # = v1 - 4 v2 + 3 v3
    t2 = e2 + e3        # = v4 - v2
    t3 = c3 - 2.0 * e3  # = 3 v3 - 4 v4 + v5
    s1 = c13 * (c1 * c1) + 0.25 * (t1 * t1)
    s2 = c13 * (c2 * c2) + 0.25 * (t2 * t2)
    s3 = c13 * (c3 * c3) + 0.25 * (t3 * t3)
    vmax = torch.maximum(
        torch.maximum(torch.maximum(v1 * v1, v2 * v2), torch.maximum(v3 * v3, v4 * v4)),
        v5 * v5,
    )
    eps = _weno_eps(vmax, v1.dtype)
    return u * _weno_combine(s1, s2, s3, eps, d1, d2, d3)


def _max_bwd(a, b, ans, gm):
    """Cotangents of ``ans = maximum(a, b)``: an exact tie splits 0.5/0.5
    (the subgradient JAX's ``max`` takes, and ``torch.maximum``'s too)."""
    ta, tb = a == ans, b == ans
    ga = gm * torch.where(ta, torch.where(tb, 0.5, 1.0), 0.0)
    gb = gm * torch.where(tb, torch.where(ta, 0.5, 1.0), 0.0)
    return ga, gb


def weno5_upwind_fwd_bwd(dm, u, g):
    """Value and hand-derived cotangents of :func:`weno5_upwind` in one pass
    (port of ``lsm_tpu.ops.stencils.weno5_upwind_fwd_bwd``): returns ``(H,
    ddm, du)`` with ``H = u * core``, ``ddm`` the six cotangents of ``dm`` and
    ``du = core * g``, for the cotangent ``g`` of ``H``.

    The association is the JAX one, term by term, including the ``vmax``
    maximum tree with 0.5/0.5 tie splitting. It is what keeps float32 right
    at WENO-symmetric cells, where the mechanical autograd of the forward
    multiplies a cancelled ``dr`` by ``r**2 ~ 1e21`` and is wrong by O(1).
    The CUDA backward kernel (``csrc/stage_backward.cu``) repeats it.
    """
    cond = u > 0
    v1 = torch.where(cond, dm[0], dm[5])
    v2 = torch.where(cond, dm[1], dm[4])
    v3 = torch.where(cond, dm[2], dm[3])
    v4 = torch.where(cond, dm[3], dm[2])
    v5 = torch.where(cond, dm[4], dm[1])
    # -- forward (the arithmetic of weno5_upwind) --
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
    sq1, sq2, sq3, sq4, sq5 = v1 * v1, v2 * v2, v3 * v3, v4 * v4, v5 * v5
    m12 = torch.maximum(sq1, sq2)
    m34 = torch.maximum(sq3, sq4)
    m14 = torch.maximum(m12, m34)
    vmax = torch.maximum(m14, sq5)
    eps = _weno_eps(vmax, v1.dtype)
    r = 1.0 / eps
    b1 = s1 * r + 1.0
    b2 = s2 * r + 1.0
    b3 = s3 * r + 1.0
    p1 = b2 * b3
    p2 = b1 * b3
    p3 = b1 * b2
    q1 = 0.1 * (p1 * p1)
    q2 = 0.6 * (p2 * p2)
    q3 = 0.3 * (p3 * p3)
    qsum = q1 + q2 + q3
    w = 1.0 / qsum
    core = (q1 * d1 + q2 * d2 + q3 * d3) * w
    H = u * core
    # -- backward (the chain above in reverse, intermediates reused) --
    du = core * g
    gc = u * g
    wgc = w * gc
    dd1 = q1 * wgc
    dd2 = q2 * wgc
    dd3 = q3 * wgc
    dq1 = (d1 - core) * wgc
    dq2 = (d2 - core) * wgc
    dq3 = (d3 - core) * wgc
    dp1 = 0.2 * p1 * dq1
    dp2 = 1.2 * p2 * dq2
    dp3 = 0.6 * p3 * dq3
    db1 = b3 * dp2 + b2 * dp3
    db2 = b3 * dp1 + b1 * dp3
    db3 = b2 * dp1 + b1 * dp2
    ds1 = r * db1
    ds2 = r * db2
    ds3 = r * db3
    dr = s1 * db1 + s2 * db2 + s3 * db3
    dvmax = -1.0e-6 * (r * r) * dr  # through eps = 1e-6 * vmax + floor
    dm14, dsq5 = _max_bwd(m14, sq5, vmax, dvmax)
    dm12, dm34 = _max_bwd(m12, m34, m14, dm14)
    dsq1, dsq2 = _max_bwd(sq1, sq2, m12, dm12)
    dsq3, dsq4 = _max_bwd(sq3, sq4, m34, dm34)
    dv1 = 2.0 * v1 * dsq1
    dv2 = 2.0 * v2 * dsq2
    dv3 = 2.0 * v3 * dsq3
    dv4 = 2.0 * v4 * dsq4
    dv5 = 2.0 * v5 * dsq5
    dc1 = 2.0 * c13 * c1 * ds1
    dc2 = 2.0 * c13 * c2 * ds2
    dc3 = 2.0 * c13 * c3 * ds3
    dt1 = 0.5 * t1 * ds1
    dt2 = 0.5 * t2 * ds2
    dt3 = 0.5 * t3 * ds3
    dc1 = dc1 + dt1
    de2 = 2.0 * dt1 + dt2
    de3 = dt2 - 2.0 * dt3
    dc3 = dc3 + dt3
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
    ddm = (
        torch.where(cond, dv1, zero),
        torch.where(cond, dv2, dv5),
        torch.where(cond, dv3, dv4),
        torch.where(cond, dv4, dv3),
        torch.where(cond, dv5, dv2),
        torch.where(cond, zero, dv1),
    )
    return H, ddm, du


def weno5_pair_diffs(p, axis, h, g, shape):
    """The six backward differences ``D- at I-2 .. I+3`` along ``axis``."""
    s = [_s(p, axis, k, g, shape) for k in range(-3, 4)]  # offsets -3..3
    inv_h = 1.0 / h
    return [(s[k + 1] - s[k]) * inv_h for k in range(6)]


def safe_sqrt(x):
    """``sqrt`` with a finite derivative at 0: forward-identical to
    ``torch.sqrt`` for ``x >= 0``."""
    safe = x > 0
    return torch.where(safe, torch.sqrt(torch.where(safe, x, 1.0)), 0.0)


# -- second derivatives --------------------------------------------------------------


def d2c(p, axis, h, g, shape):
    """Centered second derivative along ``axis``."""
    return (_s(p, axis, 1, g, shape) - 2.0 * _s(p, axis, 0, g, shape)
            + _s(p, axis, -1, g, shape)) / (h * h)


def d2pp(p, axis, h, g, shape):
    """One-sided (forward) second derivative along ``axis``."""
    return (_s(p, axis, 0, g, shape) - 2.0 * _s(p, axis, 1, g, shape)
            + _s(p, axis, 2, g, shape)) / (h * h)


def d2mm(p, axis, h, g, shape):
    """One-sided (backward) second derivative along ``axis``."""
    return (_s(p, axis, -2, g, shape) - 2.0 * _s(p, axis, -1, g, shape)
            + _s(p, axis, 0, g, shape)) / (h * h)


def d2_mixed(p, ax1, ax2, h1, h2, g, shape):
    """Mixed second derivative ``d^2 / dx_ax1 dx_ax2`` from the four edge
    neighbours."""
    n = len(shape)

    def two(a_k, b_k):
        off = [0] * n
        off[ax1] += a_k
        off[ax2] += b_k
        return shift(p, tuple(off), g, shape)

    return (two(1, 1) - two(1, -1) - two(-1, 1) + two(-1, -1)) / (4.0 * h1 * h2)


# -- ENO2 / Godunov ------------------------------------------------------------------


def minmod(x, y):
    """Minmod limiter: zero unless ``x * y > 0`` (a product that underflows
    to 0 counts as a sign change), else the smaller magnitude (``x`` on a
    tie)."""
    same = x * y > 0.0
    pick = torch.where(torch.abs(x) <= torch.abs(y), x, y)
    return torch.where(same, pick, 0.0)


def eno2_onesided(p, axis, h, g, shape):
    """Second-order ENO one-sided derivatives ``(A, B)`` along ``axis``:
    ``A = D- + 0.5 h minmod(D2--, D2_0)``, ``B = D+ - 0.5 h minmod(D2++,
    D2_0)``. Needs ``g >= 2``."""
    c = d2c(p, axis, h, g, shape)
    A = dm(p, axis, h, g, shape) + 0.5 * h * minmod(d2mm(p, axis, h, g, shape), c)
    B = dp(p, axis, h, g, shape) - 0.5 * h * minmod(d2pp(p, axis, h, g, shape), c)
    return A, B


def godunov_norms(p, spacing, g, shape):
    """Godunov upwind gradient magnitudes ``(|grad+|, |grad-|)`` with ENO2
    one-sided derivatives: ``|grad+|^2 = sum_d max(A,0)^2 + min(B,0)^2`` (for
    outward motion), ``|grad-|^2 = sum_d min(A,0)^2 + max(B,0)^2``."""
    gp2 = 0.0
    gm2 = 0.0
    for ax, h in enumerate(spacing):
        A, B = eno2_onesided(p, ax, h, g, shape)
        gp2 = gp2 + pos(A) ** 2 + neg(B) ** 2
        gm2 = gm2 + neg(A) ** 2 + pos(B) ** 2
    return safe_sqrt(gp2), safe_sqrt(gm2)


def pos(x):
    """``maximum(x, 0)``; an exact tie splits a cotangent 0.5/0.5, as JAX's
    ``maximum`` does (``clamp`` would pass all of it)."""
    return torch.maximum(x, x.new_zeros(()))


def neg(x):
    """``minimum(x, 0)``, with :func:`pos`'s tie rule."""
    return torch.minimum(x, x.new_zeros(()))
