"""Sharded adaptive evolution, dense and narrow-band (port of
:mod:`lsm_tpu.parallel.evolve`).

The reference's adaptive time loop runs per shard, each in its own thread
(:func:`~.spmd.run`): ghost layers move by the halo exchange
(:func:`~.halo.halo_pad_axis`), and the CFL bound, a minimum over the
*active* nodes of the whole grid, is a shard-local reduction followed by
:func:`~.spmd.pmin` over the mesh axes, so every shard takes the same ``dt``
and the loops stay in lockstep. The loop is the port's host loop
(``LevelSetEquation.integrate``'s general path): the bound is read back as a
host number, ``dt = min(dt_max, cfl * bound, tf - t)``.

The narrow band shards too: :class:`ShardedNarrowBandField` carries the
local active and compute masks, and ``update_band`` exchanges an
``nlayers+1``-deep halo of values and mask, so the cut-cell detection and
the dilation see across shard faces and the result equals the unsharded
band mask exactly.

``make_sharded_evolve(fused=True)`` runs the fused kernels per shard instead
(:mod:`.fused_evolve`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.grid import Grid
from ..equation import LevelSetEquation
from ..core.narrowband import NarrowBandField, _stamp_corners, box_dilate, cut_cell_mask
from ..terms.terms import compute_cfl, update_terms
from . import spmd
from .halo import _halo_pad, _ring_perm, local_field, mesh_layout, shard_terms
from .sharding import ShardedField, shard_field, unshard

__all__ = ["ShardedNarrowBandField", "sharded_band_mask", "make_sharded_evolve"]


def _exchange_pad_axis(v, axis, axis_name, n_shards, width, fill):
    """Pad one sharded axis with ``width`` layers: the exchange on interior
    faces, the constant ``fill`` on physical faces (no BC: masks and the
    re-tube, where out-of-domain neighbours do not exist)."""
    n = v.shape[axis]
    shape = list(v.shape)
    shape[axis] = width
    block = torch.full(shape, fill, dtype=v.dtype, device=v.device)
    if n_shards == 1:
        return torch.cat([block, v, block], dim=axis)
    idx = spmd.axis_index(axis_name)
    from_left = spmd.ppermute(v.narrow(axis, n - width, width), axis_name,
                              _ring_perm(n_shards, +1))
    from_right = spmd.ppermute(v.narrow(axis, 0, width), axis_name, _ring_perm(n_shards, -1))
    if idx == 0:
        from_left = block
    if idx == n_shards - 1:
        from_right = block
    return torch.cat([from_left, v, from_right], dim=axis)


def _exchange_pad(v, shard_axes, axis_sizes, width, fill):
    for d, name in enumerate(shard_axes):
        v = _exchange_pad_axis(v, d, name, axis_sizes[d] if name else 1, width, fill)
    return v


def sharded_band_mask(values, mask, nlayers, shard_axes, axis_sizes):
    """Shard-local re-tube (inside :func:`~.spmd.run`): the new active mask
    of this block, seeing across shard faces. ``mask`` (``None`` on the
    first build) restricts the cut-cell detection to fully active cells."""
    w = nlayers + 1  # 1 cell of cut-detection reach + nlayers of dilation
    v_ext = _exchange_pad(values, shard_axes, axis_sizes, w, 0.0)
    node_mask = _exchange_pad(torch.ones(values.shape, dtype=torch.bool, device=values.device),
                              shard_axes, axis_sizes, w, False)
    if mask is not None:
        node_mask = node_mask & _exchange_pad(mask, shard_axes, axis_sizes, w, False)
    m = box_dilate(_stamp_corners(cut_cell_mask(v_ext, node_mask)), nlayers)
    return m[tuple(slice(w, w + n) for n in values.shape)]


def _compute_mask(mask, shard_axes, axis_sizes):
    """The compute band of a shard's active mask, seeing across faces."""
    w = NarrowBandField.COMPUTE_HALO
    ext = _exchange_pad(mask, shard_axes, axis_sizes, w, False)
    return box_dilate(ext, w)[tuple(slice(w, w + n) for n in mask.shape)]


class ShardedNarrowBandField(NarrowBandField):
    """Shard-local view of a domain-decomposed narrow-band field: the
    masked-dense semantics of :class:`NarrowBandField`; ``pad`` exchanges
    halos on interior faces (physical faces keep the BC ghosts) and
    ``update_band`` re-tubes seeing across shard faces. ``grid`` is the
    global grid; ``shape`` is the local block's."""

    def __init__(self, values, grid, bcs, mask, nlayers, cmask, shard_axes, axis_sizes):
        # NarrowBandField.__init__ would build the masks from the block alone
        super(NarrowBandField, self).__init__(values, grid, bcs, _normalized=True)
        self.mask, self.nlayers, self._cmask = mask, int(nlayers), cmask
        self.shard_axes, self.axis_sizes = tuple(shard_axes), tuple(axis_sizes)

    @property
    def shape(self):
        return tuple(self.values.shape)

    def with_values(self, values, mask_update: bool = True):
        if mask_update:
            values = torch.where(self._cmask, values, self.values)
        return ShardedNarrowBandField(values, self.grid, self.bcs, self.mask, self.nlayers,
                                      self._cmask, self.shard_axes, self.axis_sizes)

    def pad(self, width: int) -> torch.Tensor:
        if self.bcs is None:
            raise ValueError("field has no boundary conditions")
        return _halo_pad(self.values, self.grid.ndim, self.bcs, self.shard_axes,
                         self.axis_sizes, width)

    def update_band(self) -> "ShardedNarrowBandField":
        mask = sharded_band_mask(self.values, self.mask, self.nlayers, self.shard_axes,
                                 self.axis_sizes)
        return ShardedNarrowBandField(self.values, self.grid, self.bcs, mask, self.nlayers,
                                      _compute_mask(mask, self.shard_axes, self.axis_sizes),
                                      self.shard_axes, self.axis_sizes)


def make_sharded_evolve(integrator, mesh: spmd.Mesh, grid: Grid, dt_max=math.inf,
                        max_steps: Optional[int] = None, is_band: bool = False,
                        nlayers: int = 3, fused: bool = False):
    """A sharded adaptive evolution ``(terms, phi, t0, tf) -> (phi, t,
    nsteps)``.

    ``phi`` (a :class:`MeshField` or :class:`NarrowBandField`, or its
    :class:`~.sharding.ShardedField`) is split over the mesh; with
    ``is_band=True`` the band masks come with it or are built, sharded,
    from its values. Every shard runs the adaptive loop in its own thread
    with the ``pmin``-reduced CFL bound; semantics are those of
    ``LevelSetEquation.integrate``'s general path (early stop on
    ``max_steps``; ``t`` the time reached, ``tf`` once within ``eps`` of it;
    an invalid CFL bound raises ``ValueError``).
    The result is of the kind given (a band comes back as a band).
    ``fused=True`` runs the fused kernels per shard
    (:func:`~.fused_evolve.make_sharded_fused_evolve`; dense 3D only).
    """
    if fused:
        if is_band:
            raise ValueError("fused sharded evolution is dense-only")
        from .fused_evolve import make_sharded_fused_evolve

        return make_sharded_fused_evolve(integrator, mesh, grid, dt_max=dt_max,
                                         max_steps=max_steps)
    ndim = grid.ndim
    shard_axes, axis_sizes = mesh_layout(mesh, ndim)
    used_axes = tuple(a for a, s in zip(shard_axes, axis_sizes) if a is not None and s > 1)

    def evolve_fn(terms, phi, t0, tf):
        terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
        sharded = isinstance(phi, ShardedField)
        sphi = shard_field(phi, mesh)
        local_terms = shard_terms(terms, mesh, ndim)
        tf = float(tf)
        eps = torch.finfo(sphi.dtype).eps * max(abs(tf), 1.0)

        def local(coord):
            if is_band and not sphi.is_band:
                values = sphi.blocks[coord]
                mask = sharded_band_mask(values, None, nlayers, shard_axes, axis_sizes)
                f = ShardedNarrowBandField(values, grid, sphi.bcs, mask, nlayers,
                                           _compute_mask(mask, shard_axes, axis_sizes),
                                           shard_axes, axis_sizes)
            else:
                f = local_field(sphi, coord, grid, shard_axes, axis_sizes)
            tms, t, n = local_terms[coord], float(t0), 0
            while t <= tf - eps and (max_steps is None or n < max_steps):
                tms = update_terms(tms, f, t)
                bound = compute_cfl(tms, f, t)
                if used_axes:  # the global bound: a min over every shard's active nodes
                    bound = spmd.pmin(bound, used_axes)
                bound = LevelSetEquation._checked_dt(bound.item())
                dt = min(dt_max, integrator.cfl * bound, tf - t)
                f, tms = integrator.advance(tms, f, t, dt)
                f = f.update_band()  # a no-op on a dense field
                t += dt
                n += 1
            return f, (tf if t > tf - eps else t), n

        out = spmd.run(mesh, local)
        first = out.flat[0]
        blocks = _map(out, lambda r: r[0].values)
        if is_band:
            res = ShardedField(mesh, grid, sphi.bcs, blocks, _map(out, lambda r: r[0].mask),
                               _map(out, lambda r: r[0].compute_mask), nlayers)
        else:
            res = sphi.with_blocks(blocks)
        return (res if sharded else unshard(res, phi.values.device)), first[1], first[2]

    return evolve_fn


def _map(arr, fn):
    out = arr.copy()
    for i, x in enumerate(arr.flat):
        out.flat[i] = fn(x)
    return out

