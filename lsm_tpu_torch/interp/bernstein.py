"""Tensor-product Bernstein polynomials, batched (port of
:mod:`lsm_tpu.interp.bernstein`).

Coefficients live in tensors with ``N`` trailing coefficient axes; evaluation
is a sequence of basis-vector contractions over them, batched over leading
axes (points, cells). Gradients and Hessians are closed forms: the same
contractions with the derivatives of the basis vectors on the differentiated
axes (``B'_k = n (B^{n-1}_{k-1} - B^{n-1}_k)``), scaled by the box widths —
what ``jax.grad`` / ``jax.hessian`` of the evaluation compute, to
round-off. Also the algebra the quadrature needs: convex-hull bounds,
derivative polynomials, de Casteljau subdivision and face restrictions.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

__all__ = [
    "bernstein_basis",
    "bernstein_eval",
    "bernstein_value_grad",
    "bernstein_value_grad_hess",
    "bernstein_derivative",
    "bernstein_bounds",
    "bernstein_split",
    "bernstein_face",
]


def _binomials(n: int) -> np.ndarray:
    return np.asarray([math.comb(n, k) for k in range(n + 1)], dtype=np.float64)


def bernstein_basis(degree: int, t) -> torch.Tensor:
    """Basis vector ``B_k(t) = C(d,k) t^k (1-t)^(d-k)``, ``k = 0..degree``;
    ``t`` a scalar or a tensor, the basis axis appended last."""
    t = torch.as_tensor(t)
    if not t.is_floating_point():
        t = t.to(torch.float64)
    k = torch.arange(degree + 1, dtype=t.dtype, device=t.device)
    binom = torch.as_tensor(_binomials(degree), dtype=t.dtype, device=t.device)
    tt = t[..., None]
    one = torch.ones((), dtype=t.dtype, device=t.device)
    # guard 0^0 at the endpoints
    pow_t = torch.where(k == 0, one, tt ** k)
    pow_1mt = torch.where(k == degree, one, (1.0 - tt) ** (degree - k))
    return binom * pow_t * pow_1mt


def _basis_derivative(degree: int, t: torch.Tensor, order: int) -> torch.Tensor:
    """``d^order/dt^order`` of :func:`bernstein_basis`: ``B'^n_k = n
    (B^{n-1}_{k-1} - B^{n-1}_k)`` applied ``order`` times (0 where the
    degree runs out)."""
    if order == 0:
        return bernstein_basis(degree, t)
    if degree == 0:
        return torch.zeros(t.shape + (1,), dtype=t.dtype, device=t.device)
    low = _basis_derivative(degree - 1, t, order - 1)
    zero = torch.zeros(low.shape[:-1] + (1,), dtype=low.dtype, device=low.device)
    return degree * (torch.cat([zero, low], -1) - torch.cat([low, zero], -1))


def _contract(coeffs: torch.Tensor, bases: List[torch.Tensor]) -> torch.Tensor:
    """Contract the trailing ``len(bases)`` axes of ``coeffs`` with one basis
    vector each (``bases[d]`` of shape batch + (n_d,)), axis 0 first."""
    out = coeffs
    ndim = len(bases)
    for d, basis in enumerate(bases):
        remaining = ndim - d  # coefficient axes still uncontracted (the last ones)
        moved = torch.movedim(out, -remaining, -1)
        b = basis.reshape(basis.shape[:-1] + (1,) * (remaining - 1) + basis.shape[-1:])
        out = (moved * b).sum(-1)
    return out


def _unit(coeffs, lo, hi, x):
    """``(t, widths, ndim)``: ``x`` in the box's unit coordinates."""
    like = coeffs
    lo, hi, x = (torch.as_tensor(a, dtype=like.dtype, device=like.device) for a in (lo, hi, x))
    w = hi - lo
    return (x - lo) / w, w, x.shape[-1] if x.ndim else 1


def _bases(coeffs, t, ndim, orders):
    degs = coeffs.shape[coeffs.ndim - ndim:]
    return [_basis_derivative(n - 1, t[..., d], o) for d, (n, o) in enumerate(zip(degs, orders))]


def bernstein_eval(coeffs: torch.Tensor, lo, hi, x) -> torch.Tensor:
    """The tensor-product Bernstein polynomial on the box ``[lo, hi]`` at
    ``x``: ``coeffs`` has one trailing axis per dimension, ``lo``, ``hi`` and
    ``x`` a trailing axis of ``N``; leading axes broadcast (points, cells)."""
    t, _, ndim = _unit(coeffs, lo, hi, x)
    return _contract(coeffs, _bases(coeffs, t, ndim, (0,) * ndim))


def bernstein_value_grad(coeffs, lo, hi, x):
    """Value and gradient at ``x`` (reference ``value_and_gradient``)."""
    t, w, ndim = _unit(coeffs, lo, hi, x)
    base = _bases(coeffs, t, ndim, (0,) * ndim)
    val = _contract(coeffs, base)
    grads = []
    for d in range(ndim):
        bs = list(base)
        bs[d] = _basis_derivative(coeffs.shape[coeffs.ndim - ndim + d] - 1, t[..., d], 1)
        grads.append(_contract(coeffs, bs) / w[..., d])
    return val, torch.stack(grads, -1)


def bernstein_value_grad_hess(coeffs, lo, hi, x):
    """Value, gradient and Hessian at ``x``."""
    t, w, ndim = _unit(coeffs, lo, hi, x)
    degs = coeffs.shape[coeffs.ndim - ndim:]
    der = [[_basis_derivative(degs[d] - 1, t[..., d], o) for o in range(3)]
           for d in range(ndim)]

    def term(orders):
        return _contract(coeffs, [der[d][o] for d, o in enumerate(orders)])

    val = term((0,) * ndim)
    grads, hess = [], [[None] * ndim for _ in range(ndim)]
    for d in range(ndim):
        grads.append(term(tuple(int(e == d) for e in range(ndim))) / w[..., d])
        for e in range(d, ndim):
            orders = [0] * ndim
            orders[d] += 1
            orders[e] += 1
            hess[d][e] = hess[e][d] = term(tuple(orders)) / (w[..., d] * w[..., e])
    H = torch.stack([torch.stack(row, -1) for row in hess], -2)
    return val, torch.stack(grads, -1), H


def _coeff_axis(coeffs: torch.Tensor, ndim: int, axis: int) -> int:
    """Index of the coefficient axis of spatial ``axis`` (the last N axes)."""
    return coeffs.ndim - ndim + axis


def bernstein_derivative(coeffs: torch.Tensor, ndim: int, axis: int, lo, hi) -> torch.Tensor:
    """Coefficients of ``d/dx_axis p`` (degree one lower along ``axis``):
    ``d (c_{i+1} - c_i) / (hi - lo)``."""
    ax = _coeff_axis(coeffs, ndim, axis)
    n = coeffs.shape[ax]
    upper = coeffs.narrow(ax, 1, n - 1)
    lower = coeffs.narrow(ax, 0, n - 1)
    return (upper - lower) * ((n - 1) / (hi[axis] - lo[axis]))


def bernstein_bounds(coeffs: torch.Tensor, ndim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convex-hull bounds ``(min, max)`` over the last ``ndim`` axes."""
    flat = coeffs.reshape(coeffs.shape[:coeffs.ndim - ndim] + (-1,))
    return flat.amin(-1), flat.amax(-1)


def _decasteljau_tables(n: int, t: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Matrices ``L``, ``R``: ``L @ c`` and ``R @ c`` the Bernstein
    coefficients of the two pieces of a degree-(n-1) curve split at ``t``."""
    L = np.zeros((n, n))
    R = np.zeros((n, n))
    tri = np.eye(n)
    L[0] = tri[0]
    R[n - 1] = tri[n - 1]
    for k in range(1, n):
        tri = (1 - t) * tri[:-1] + t * tri[1:]
        L[k] = tri[0]
        R[n - 1 - k] = tri[-1]
    return L, R


def bernstein_split(coeffs: torch.Tensor, ndim: int, axis: int, t: float = 0.5):
    """Split along ``axis`` at parameter ``t`` (de Casteljau):
    ``(left_coeffs, right_coeffs)``."""
    ax = _coeff_axis(coeffs, ndim, axis)
    L, R = _decasteljau_tables(coeffs.shape[ax], t)
    moved = torch.movedim(coeffs, ax, -1)
    as_t = lambda m: torch.as_tensor(m, dtype=coeffs.dtype, device=coeffs.device)
    return (torch.movedim(moved @ as_t(L).T, -1, ax), torch.movedim(moved @ as_t(R).T, -1, ax))


def bernstein_face(coeffs: torch.Tensor, ndim: int, axis: int, side: int) -> torch.Tensor:
    """Restrict to the face ``x_axis = lo`` (``side=0``) or ``x_axis = hi``
    (``side=1``)."""
    ax = _coeff_axis(coeffs, ndim, axis)
    return coeffs.select(ax, 0 if side == 0 else coeffs.shape[ax] - 1)
