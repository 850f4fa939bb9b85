"""Continuous fields: piecewise tensor-product Bernstein interpolation (port
of :mod:`lsm_tpu.interp.interpolation`).

The coefficients of every cell are computed in one pass as a batched
Kronecker application (per dimension, a stack of ``nv`` shifted slices
contracted with the shared 1D interpolation matrix), or, above
``LAZY_THRESHOLD`` coefficients, on demand per batch of cells from the padded
nodal values. Evaluation is a gather and a batched contraction
(:mod:`.bernstein`) over any batch of query points; gradients and Hessians
use the closed forms of the patch's derivatives. Plain torch on the field's
device (JAX's is XLA; no TPU kernel runs it).

The 1D interpolation matrix maps ``stencil_order+1`` equispaced nodal values
to the ``order+1`` Bernstein coefficients of the central cell: the pseudo
inverse of the Bernstein Vandermonde (even order: least squares on an
``order+1`` stencil).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.bc import Extrapolation
from ..core.field import MeshField
from .bernstein import bernstein_eval, bernstein_value_grad, bernstein_value_grad_hess

__all__ = ["InterpolatedField", "interpolation_matrix"]


def _stencil_order(order: int) -> int:
    return order if order % 2 == 1 else order + 1


def interpolation_matrix(order: int) -> np.ndarray:
    """(order+1) x (stencil_order+1) matrix: nodal values -> Bernstein coeffs
    on the central cell ``[(s-1)/(2s), (s+1)/(2s)]`` of the unit stencil."""
    s = _stencil_order(order)
    nc, nv = order + 1, s + 1
    nodes = np.arange(nv) / s
    a, b = (s - 1) / (2 * s), (s + 1) / (2 * s)
    t = (nodes - a) / (b - a)
    V = np.empty((nv, nc))
    for j in range(nc):
        V[:, j] = math.comb(order, j) * t ** j * (1 - t) ** (order - j)
    return np.linalg.pinv(V)


def _all_cell_coeffs(padded: torch.Tensor, mat: torch.Tensor, cells_shape, pad: int, off: int):
    """Bernstein coefficients of every cell: shape ``(*cells_shape, nc, ..., nc)``."""
    nc, nv = mat.shape
    A = padded
    for d in range(len(cells_shape)):
        start = pad + off
        S = torch.stack([A.narrow(d, start + k, cells_shape[d]) for k in range(nv)], 0)
        A = torch.movedim(torch.tensordot(mat, S, dims=([1], [0])), 0, -1)
    return A


class InterpolatedField:
    """Continuous field: a discrete field and a degree-``order`` Bernstein
    patch per cell.

    ``cf(x)`` with ``x`` a length-N point or an ``(..., N)`` batch;
    ``gradient`` / ``hessian`` / ``value_and_gradient`` /
    ``value_gradient_hessian`` differentiate the same local patch.
    ``cell_extrema`` / ``proven_empty`` use the Bernstein convex-hull
    property. ``lazy`` (default: above ``LAZY_THRESHOLD`` coefficients)
    keeps the padded nodal values and computes coefficients per batch.
    """

    #: above this many coefficient floats, switch to the lazy per-batch path
    LAZY_THRESHOLD = 1 << 26

    def __init__(self, field: MeshField, order: int = 3, lazy: Optional[bool] = None):
        if not field.has_bcs():
            field = field.with_bcs(Extrapolation(order))
        self.field = field
        self.order = int(order)
        mat = torch.as_tensor(interpolation_matrix(self.order), dtype=field.dtype,
                              device=field.values.device)
        nv = mat.shape[1]
        self._mat, self._pad, self._off = mat, (nv - 1) // 2, -((nv - 2) // 2)
        ncoef = math.prod(field.grid.cells_shape) * (self.order + 1) ** field.ndim
        if lazy is None:
            lazy = ncoef > self.LAZY_THRESHOLD
        padded = field.pad(self._pad)
        if lazy:  # O(grid) memory instead of O(grid * (order+1)^N)
            self.coeffs, self._padded = None, padded
        else:
            self.coeffs = _all_cell_coeffs(padded, mat, field.grid.cells_shape, self._pad,
                                           self._off)
            self._padded = None

    @property
    def is_lazy(self) -> bool:
        return self.coeffs is None

    @property
    def grid(self):
        return self.field.grid

    @property
    def ndim(self):
        return self.field.ndim

    @property
    def device(self):
        return self._mat.device

    def _cell_box(self, cell_idx: torch.Tensor):
        dtype = self.field.dtype
        lo = torch.as_tensor(self.grid.lo, dtype=dtype, device=self.device)
        h = torch.as_tensor(self.grid.spacing, dtype=dtype, device=self.device)
        cl = lo + cell_idx.to(dtype) * h
        return cl, cl + h

    def _gather_coeffs(self, cell_idx: torch.Tensor):
        """Coefficient blocks of (batched) cell multi-indices ``(..., N)``."""
        if self.is_lazy:
            return self._coeffs_on_demand(cell_idx)
        nc, ndim = self.order + 1, self.ndim
        flat = self.coeffs.reshape((-1,) + (nc,) * ndim)
        cells = self.grid.cells_shape
        strides = torch.as_tensor(np.cumprod((cells[1:] + (1,))[::-1])[::-1].copy(),
                                  dtype=torch.int64, device=self.device)
        lin = (cell_idx.to(torch.int64) * strides).sum(-1)
        return flat[lin]

    def _coeffs_on_demand(self, cell_idx: torch.Tensor):
        """Lazy path: each cell's ``(nv,)*N`` nodal stencil gathered from the
        padded values and contracted with the 1D matrix per dimension (the
        math of :func:`_all_cell_coeffs`)."""
        ndim, mat = self.ndim, self._mat
        nc, nv = mat.shape
        base = cell_idx.to(torch.int64) + (self._pad + self._off)  # stencil start
        ar = torch.arange(nv, device=self.device)
        idxs = []
        for d in range(ndim):
            ix = base[..., d].reshape(base.shape[:-1] + (1,) * ndim)
            shape_d = [1] * ndim
            shape_d[d] = nv
            idxs.append(ix + ar.reshape(shape_d))
        A = self._padded[tuple(idxs)]  # (..., nv, ..., nv)
        for _ in range(ndim):
            # consume the first trailing stencil axis, append its coefficient
            # axis last: after ndim rounds the trailing axes are (nc,)*ndim
            A = torch.tensordot(A, mat, dims=([A.ndim - ndim], [1]))
        return A

    # -- evaluation -------------------------------------------------------------------

    def _point_eval(self, fn, x):
        x = torch.as_tensor(x, dtype=self.field.dtype, device=self.device)
        single = x.ndim == 1
        pts = x[None] if single else x
        cell = self.grid.locate_cell(pts)
        lo, hi = self._cell_box(cell)
        out = fn(self._gather_coeffs(cell), lo, hi, pts)
        if single:
            out = tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]
        return out

    def __call__(self, x) -> torch.Tensor:
        return self._point_eval(bernstein_eval, x)

    def gradient(self, x) -> torch.Tensor:
        return self._point_eval(lambda *a: bernstein_value_grad(*a)[1], x)

    def hessian(self, x) -> torch.Tensor:
        return self._point_eval(lambda *a: bernstein_value_grad_hess(*a)[2], x)

    def value_and_gradient(self, x):
        return self._point_eval(bernstein_value_grad, x)

    def value_gradient_hessian(self, x):
        return self._point_eval(bernstein_value_grad_hess, x)

    # -- cell queries -----------------------------------------------------------------

    def make_interpolant(self, cell_index: Sequence[int]):
        """``(coeffs, lo, hi)`` of the Bernstein patch of one cell."""
        idx = torch.as_tensor(cell_index, dtype=torch.int64, device=self.device)
        blocks = self._gather_coeffs(idx[None])[0]
        lo, hi = self._cell_box(idx)
        return blocks, lo, hi

    def local_interpolant(self, x):
        x = torch.as_tensor(x, dtype=self.field.dtype, device=self.device)
        return self.make_interpolant(self.grid.locate_cell(x))

    def cell_extrema(self, cell_index: Optional[Sequence[int]] = None, chunk: int = 1 << 17):
        """Convex-hull ``(min, max)`` bounds: one cell, or every cell at once
        (a lazy field computes them ``chunk`` cells at a time)."""
        ndim = self.ndim
        red = lambda b: (b.reshape(b.shape[:b.ndim - ndim] + (-1,)).amin(-1),
                         b.reshape(b.shape[:b.ndim - ndim] + (-1,)).amax(-1))
        if cell_index is not None:
            blocks = self._gather_coeffs(
                torch.as_tensor(cell_index, dtype=torch.int64, device=self.device)[None])[0]
            return blocks.min(), blocks.max()
        if not self.is_lazy:
            return red(self.coeffs)
        cells = self.grid.cells_shape
        ncells = math.prod(cells)
        mins = torch.empty(ncells, dtype=self.field.dtype, device=self.device)
        maxs = torch.empty_like(mins)
        for start in range(0, ncells, chunk):
            lin = torch.arange(start, min(start + chunk, ncells), device=self.device)
            multi = torch.stack(torch.unravel_index(lin, cells), -1)
            mins[start:start + len(lin)], maxs[start:start + len(lin)] = red(
                self._gather_coeffs(multi))
        return mins.reshape(cells), maxs.reshape(cells)

    def proven_empty(self, cell_index: Optional[Sequence[int]] = None, surface: bool = False):
        """True where a cell provably holds no interface (``surface=True``:
        ``min * max > 0``) or no interior (``min > 0``)."""
        m, M = self.cell_extrema(cell_index)
        return (m * M > 0) if surface else (m > 0)

    def __repr__(self):
        return f"InterpolatedField (order {self.order}) wrapping {self.field!r}"
