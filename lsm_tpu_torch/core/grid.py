"""Uniform Cartesian grid geometry (port of :mod:`lsm_tpu.core.grid`).

A frozen description of a tensor-product node lattice ``[lo, hi]`` with
``shape[d]`` nodes per dimension and spacing ``h[d] = (hi[d] - lo[d]) /
(shape[d] - 1)``. Node ``i`` (0-based) along dimension ``d`` sits at
``lo[d] + i * h[d]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device

__all__ = ["Grid"]


@dataclasses.dataclass(frozen=True)
class Grid:
    """Uniform Cartesian grid with nodes at ``lo + i*h``, ``i = 0 .. shape[d]-1``."""

    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    shape: Tuple[int, ...]

    def __init__(self, lo: Sequence[float], hi: Sequence[float], shape: Sequence[int]):
        lo = tuple(float(v) for v in lo)
        hi = tuple(float(v) for v in hi)
        shape = tuple(int(v) for v in shape)
        if not (len(lo) == len(hi) == len(shape)):
            raise ValueError("lo, hi and shape must have the same length")
        if any(n < 2 for n in shape):
            raise ValueError("grids need at least 2 nodes per dimension")
        if any(h <= l for l, h in zip(lo, hi)):
            raise ValueError("hi must be strictly greater than lo in every dimension")
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)
        object.__setattr__(self, "shape", shape)

    @staticmethod
    def from_meshsize(lo: Sequence[float], hi: Sequence[float], meshsize) -> "Grid":
        """Grid spanning ``[lo, hi]`` with spacing at most ``meshsize`` per
        dimension: the domain is kept exactly and the cell count rounded up."""
        lo = tuple(float(v) for v in lo)
        hi = tuple(float(v) for v in hi)
        ndim = len(lo)
        hs = (float(meshsize),) * ndim if np.isscalar(meshsize) else tuple(
            float(v) for v in meshsize)
        if len(hs) != ndim:
            raise ValueError("meshsize must be a scalar or have one entry per dimension")
        if any(h <= 0 for h in hs):
            raise ValueError("meshsize must be positive in every dimension")
        shape = tuple(int(math.ceil((b - a) / h - 1e-12)) + 1 for a, b, h in zip(lo, hi, hs))
        return Grid(lo, hi, shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spacing(self) -> Tuple[float, ...]:
        return tuple((b - a) / (n - 1) for a, b, n in zip(self.lo, self.hi, self.shape))

    @property
    def min_spacing(self) -> float:
        return min(self.spacing)

    @property
    def cell_volume(self) -> float:
        return float(np.prod(self.spacing))

    @property
    def num_nodes(self) -> int:
        return int(np.prod(self.shape))

    @property
    def cells_shape(self) -> Tuple[int, ...]:
        return tuple(n - 1 for n in self.shape)

    def axis_coords(self, dim: int, dtype=torch.float64, device=None) -> torch.Tensor:
        """1-D tensor of node coordinates along dimension ``dim``; ``device``
        defaults to the card (:func:`~lsm_tpu_torch.core.device.resolve_device`)."""
        return torch.linspace(self.lo[dim], self.hi[dim], self.shape[dim],
                              dtype=dtype, device=resolve_device(device))

    def coords(self, dtype=torch.float64, device=None):
        """Tuple of N broadcastable coordinate tensors (sparse, ij-indexing),
        on the card unless ``device`` says otherwise."""
        device = resolve_device(device)
        out = []
        for d in range(self.ndim):
            view = [1] * self.ndim
            view[d] = self.shape[d]
            out.append(self.axis_coords(d, dtype, device).reshape(view))
        return tuple(out)

    def dense_coords(self, dtype=torch.float64, device=None):
        """Tuple of N dense coordinate tensors of shape ``self.shape``, on the
        card unless ``device`` says otherwise."""
        device = resolve_device(device)
        axes = [self.axis_coords(d, dtype, device) for d in range(self.ndim)]
        return tuple(torch.meshgrid(*axes, indexing="ij"))

    def node(self, index: Sequence[int]) -> Tuple[float, ...]:
        """Coordinates of the node at (0-based) multi-index ``index``; indices
        outside the grid give ghost-node coordinates."""
        return tuple(a + i * h for a, i, h in zip(self.lo, index, self.spacing))

    def cell_center(self, index: Sequence[int]) -> Tuple[float, ...]:
        return tuple(a + (i + 0.5) * h for a, i, h in zip(self.lo, index, self.spacing))

    def locate_cell(self, x: torch.Tensor) -> torch.Tensor:
        """Cell multi-index (int32) containing point(s) ``x`` (shape (..., N)),
        clamped to the grid's cells."""
        lo = torch.as_tensor(self.lo, dtype=x.dtype, device=x.device)
        h = torch.as_tensor(self.spacing, dtype=x.dtype, device=x.device)
        idx = torch.floor((x - lo) / h).to(torch.int32)
        hi = torch.as_tensor([n - 2 for n in self.shape], dtype=torch.int32, device=x.device)
        return torch.minimum(torch.clamp(idx, min=0), hi)

    def __repr__(self) -> str:
        dom = " x ".join(f"[{a:g}, {b:g}]" for a, b in zip(self.lo, self.hi))
        nodes = " x ".join(str(n) for n in self.shape)
        h = ", ".join(f"{v:.4g}" for v in self.spacing)
        return (
            f"Grid in R^{self.ndim}\n"
            f"  |- domain:  {dom}\n"
            f"  |- nodes:   {nodes}\n"
            f"  `- spacing: h = ({h})"
        )
