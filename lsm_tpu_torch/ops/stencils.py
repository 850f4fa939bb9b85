"""Whole-array finite-difference and WENO5 stencils (port of the parts of
:mod:`lsm_tpu.ops.stencils` the advection path needs).

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
    "PAD_WENO5",
    "shift",
    "d0",
    "dp",
    "dm",
    "weno5_pair_diffs",
    "weno5_upwind",
    "safe_sqrt",
]

PAD_D0 = 1
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
