"""Uniform Cartesian grid geometry (port of :mod:`lsm_tpu.core.grid`).

A frozen description of a tensor-product node lattice ``[lo, hi]`` with
``shape[d]`` nodes per dimension and spacing ``h[d] = (hi[d] - lo[d]) /
(shape[d] - 1)``. Node ``i`` (0-based) along dimension ``d`` sits at
``lo[d] + i * h[d]``.
"""

from __future__ import annotations

import dataclasses
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
