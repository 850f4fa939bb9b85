"""Narrow-band level-set fields as masked dense tensors (port of
:mod:`lsm_tpu.core.narrowband`).

The band is a dense boolean *active mask* over the whole grid:

- ``mask`` marks the active band: the corners of the cut cells (cells whose
  corner values straddle zero, among cells whose corners are all active),
  dilated by a box of radius ``nlayers``.
- Updates apply on the *compute band*, the active mask dilated by
  ``COMPUTE_HALO = 3`` (WENO5's reach), so a node that joins the band at a
  re-tube already holds a correctly evolved value.
- Off-band nodes keep frozen values whose sign stays right, so the dense
  measures (volume, perimeter) need nothing band-specific.

Masks are ``torch.bool``. Periodic BCs are rejected, as in the JAX package.
"""

from __future__ import annotations

import operator
from typing import Optional

import torch

from .bc import Periodic, bcs_str, normalize_bcs
from .device import dtype_str
from .field import MeshField

__all__ = ["NarrowBandField", "box_dilate", "l1_dilate", "cut_cell_mask",
           "band_mask_from_values"]


def _pad_false(mask: torch.Tensor, ax: int, before: int, after: int) -> torch.Tensor:
    """``mask`` with ``before``/``after`` False layers added along ``ax``."""
    parts = []
    for n in (before, None, after):
        if n is None:
            parts.append(mask)
        elif n:
            shape = list(mask.shape)
            shape[ax] = n
            parts.append(torch.zeros(shape, dtype=mask.dtype, device=mask.device))
    return torch.cat(parts, dim=ax) if len(parts) > 1 else mask


def _shift(mask: torch.Tensor, s: int, ax: int) -> torch.Tensor:
    """``out[i] = mask[i + s]`` along ``ax``, False past the edge."""
    n = mask.shape[ax]
    if s > 0:
        return _pad_false(mask.narrow(ax, s, n - s), ax, 0, s)
    return _pad_false(mask.narrow(ax, 0, n + s), ax, -s, 0)


def box_dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilate a boolean mask by the L-inf ball (box) of ``radius``, with
    False beyond the borders. Separable: per axis, one padded copy and a
    ``(2r+1)``-way OR of its shifted slices."""
    if radius == 0:
        return mask
    for ax in range(mask.ndim):
        n = mask.shape[ax]
        p = _pad_false(mask, ax, radius, radius)
        acc = p.narrow(ax, 0, n)
        for d in range(1, 2 * radius + 1):
            acc = acc | p.narrow(ax, d, n)
        mask = acc
    return mask


def l1_dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilate a boolean mask by an L1 ball of ``radius`` (iterated cross
    dilation). The band itself uses :func:`box_dilate`."""
    for _ in range(radius):
        out = mask
        for ax in range(mask.ndim):
            out = out | _shift(mask, 1, ax) | _shift(mask, -1, ax)
        mask = out
    return mask


def _corner_reduce(x: torch.Tensor, op) -> torch.Tensor:
    """Separable reduction of a node tensor over the ``2^N`` corners of each
    cell (``op`` OR for "any corner", AND for "all corners")."""
    for ax in range(x.ndim):
        n = x.shape[ax]
        x = op(x.narrow(ax, 0, n - 1), x.narrow(ax, 1, n - 1))
    return x


def cut_cell_mask(values: torch.Tensor, node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cells whose corner values straddle zero (some corner ``<= 0`` and some
    ``>= 0``); with ``node_mask``, only cells whose corners are all active."""
    cut = _corner_reduce(values <= 0, operator.or_) & _corner_reduce(values >= 0, operator.or_)
    if node_mask is not None:
        cut = cut & _corner_reduce(node_mask, operator.and_)
    return cut


def _stamp_corners(cell_mask: torch.Tensor) -> torch.Tensor:
    """Node mask marking every corner of the marked cells (separable
    shifted OR)."""
    m = cell_mask
    for ax in range(cell_mask.ndim):
        m = _pad_false(m, ax, 0, 1)  # cell c touches nodes c and c+1
        m = m | _shift(m, -1, ax)
    return m


def band_mask_from_values(values: torch.Tensor, nlayers: int,
                          node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Active mask: the corners of the cut cells, dilated by a box of
    ``nlayers``."""
    return box_dilate(_stamp_corners(cut_cell_mask(values, node_mask)), nlayers)


class NarrowBandField(MeshField):
    """Masked dense narrow-band field; takes a :class:`MeshField`'s place in
    the evolution stack."""

    #: how far the compute band reaches beyond the active band
    COMPUTE_HALO = 3

    def __init__(self, values, grid, bcs=None, mask=None, nlayers: int = 3,
                 _normalized=False, _cmask=None):
        if not _normalized:
            bcs = normalize_bcs(bcs, grid.ndim)
        if bcs is not None and any(isinstance(b, Periodic) for pair in bcs for b in pair):
            raise ValueError("Periodic BCs are not supported on a NarrowBandField")
        if nlayers < self.COMPUTE_HALO:
            raise ValueError(
                f"nlayers must be >= {self.COMPUTE_HALO} (the stencil halo) "
                "so band ghosts never fire inside the stencil reach")
        super().__init__(values, grid, bcs, _normalized=True)
        if mask is None:
            mask = band_mask_from_values(values, nlayers)
        self.mask = mask
        self.nlayers = int(nlayers)
        # a pure function of the mask, carried so that with_values does not
        # dilate again at every stage
        self._cmask = box_dilate(mask, self.COMPUTE_HALO) if _cmask is None else _cmask

    @staticmethod
    def from_field(phi: MeshField, nlayers: int = 3) -> "NarrowBandField":
        """The band of a full-grid field."""
        return NarrowBandField(phi.values, phi.grid, phi.bcs, None, nlayers, _normalized=True)

    @property
    def active_mask(self) -> torch.Tensor:
        return self.mask

    @property
    def compute_mask(self) -> torch.Tensor:
        """The active band plus the stencil halo: where updates land."""
        return self._cmask

    def active_count(self) -> torch.Tensor:
        return self.mask.sum()

    def with_values(self, values: torch.Tensor, mask_update: bool = True) -> "NarrowBandField":
        """Masked update: new values land on the compute band, the others
        stay frozen."""
        if mask_update:
            values = torch.where(self._cmask, values, self.values)
        return NarrowBandField(values, self.grid, self.bcs, self.mask, self.nlayers,
                               _normalized=True, _cmask=self._cmask)

    def with_bcs(self, bc, *, replace: bool = False) -> "NarrowBandField":
        if self.bcs is not None and not replace:
            raise ValueError("field already has boundary conditions")
        return NarrowBandField(self.values, self.grid, normalize_bcs(bc, self.ndim), self.mask,
                               self.nlayers, _normalized=True, _cmask=self._cmask)

    def update_band(self) -> "NarrowBandField":
        """Re-tube: the active mask from the current values (cut cells among
        active cells, dilated ``nlayers``)."""
        new_mask = band_mask_from_values(self.values, self.nlayers, self.mask)
        return NarrowBandField(self.values, self.grid, self.bcs, new_mask, self.nlayers,
                               _normalized=True)

    def __repr__(self):
        nodes = " x ".join(str(n) for n in self.shape)
        return (
            f"NarrowBandField ({dtype_str(self.values.dtype)})\n"
            f"  |- grid:   {nodes} nodes in R^{self.ndim}\n"
            f"  |- active: {int(self.mask.sum())} nodes ({self.nlayers}-layer halo)\n"
            f"  |- bcs:    {bcs_str(self.bcs)}\n"
            f"  `- device: {self.values.device}"
        )
