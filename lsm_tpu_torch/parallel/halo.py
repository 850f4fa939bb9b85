"""Explicit halo exchange over an in-process mesh (port of
:mod:`lsm_tpu.parallel.halo`).

The grid is split over the mesh's axes (:mod:`.sharding`), and a shard's
ghost layers come from

- **interior faces**: :func:`~.spmd.ppermute` ring shifts of the
  neighbours' edge slabs (width = the stencil reach, 3 for WENO5),
- **physical faces** (outermost shards): the ordinary BC ghost blocks of
  :mod:`lsm_tpu_torch.core.bc`, from shard-local data,
- **the periodic wrap**: the ring shift *with the duplicated-endpoint
  correction*: the global grid stores both endpoints of a periodic
  dimension (``phi[0] == phi[n-1]``, period ``n-1`` nodes), so the last
  shard sends ``[n-1-w, n-1)`` on the wrap and shard 0 sends ``[1, w+1)``.

:class:`HaloField` is a :class:`~lsm_tpu_torch.core.field.MeshField` whose
``pad(width)`` exchanges halos instead of padding locally. The port's terms
reach ghosts only through ``phi.pad``, so the general path (its integrators
and terms, K10/K11 on the card) runs unchanged per shard inside
:func:`~.spmd.run`: :func:`make_sharded_step` is ``integrator.advance`` on
a :class:`HaloField`. Corner ghosts compose as the local pad's do: axes are
exchanged in order, and a later axis's slab holds the earlier axes' halos.

A coefficient the terms evaluate at coordinates (a callable ``f(xs, t)``)
would see the global grid's coordinates beside shard-local values; the
general path raises ``ValueError`` naming the term (JAX's rejects it by
omission). The fused path (:mod:`.fused_evolve`) evaluates callables at each
shard's global coordinates.
"""

from __future__ import annotations

import torch

from ..core import bc as _bc
from ..core.field import MeshField
from ..core.grid import Grid
from ..terms.terms import (AdvectionTerm, CurvatureTerm, EikonalReinitializationTerm,
                           NormalMotionTerm)
from . import spmd
from .sharding import ShardedField, constrain, shard_field, unshard

__all__ = ["HaloField", "halo_pad_axis", "make_sharded_step"]


def _ring_perm(n: int, shift: int):
    return [(i, (i + shift) % n) for i in range(n)]


def halo_pad_axis(v: torch.Tensor, axis: int, axis_name: str, n_shards: int, bc_pair,
                  width: int) -> torch.Tensor:
    """Pad one *sharded* axis of a shard-local tensor with ``width`` ghost
    layers: the ring exchange on interior faces, BC ghosts on physical faces
    (inside :func:`~.spmd.run`)."""
    if n_shards == 1:
        return _bc.pad_axis(v, bc_pair, axis, width)
    left_bc, right_bc = bc_pair
    periodic = isinstance(left_bc, _bc.Periodic)
    idx = spmd.axis_index(axis_name)
    n = v.shape[axis]
    # the slab sent rightward becomes the right neighbour's LEFT halo; on the
    # periodic wrap the last shard skips its duplicated endpoint
    wrap_r = periodic and idx == n_shards - 1
    send_right = v.narrow(axis, n - width - 1 if wrap_r else n - width, width)
    from_left = spmd.ppermute(send_right, axis_name, _ring_perm(n_shards, +1))
    # the slab sent leftward becomes the left neighbour's RIGHT halo; shard
    # 0's wrap message skips its duplicated endpoint (right ghost k = node k)
    send_left = v.narrow(axis, 1 if periodic and idx == 0 else 0, width)
    from_right = spmd.ppermute(send_left, axis_name, _ring_perm(n_shards, -1))
    if not periodic:  # physical faces: the BC ghosts replace the wrap messages
        if idx == 0:
            from_left = _bc._ghost_block(v, left_bc, axis, width, "left")
        if idx == n_shards - 1:
            from_right = _bc._ghost_block(v, right_bc, axis, width, "right")
    return torch.cat([from_left, v, from_right], dim=axis)


class HaloField(MeshField):
    """Shard-local view of a domain-decomposed field.

    ``shard_axes[d]`` is the mesh axis dimension ``d`` is split over (or
    ``None``), ``axis_sizes[d]`` its shard count. ``grid`` is the *global*
    grid (the spacing's source); ``shape`` is the local block's.
    """

    def __init__(self, values, grid: Grid, bcs, shard_axes, axis_sizes):
        super().__init__(values, grid, bcs, _normalized=True)
        self.shard_axes = tuple(shard_axes)
        self.axis_sizes = tuple(axis_sizes)

    @property
    def shape(self):
        return tuple(self.values.shape[1:] if self.is_vector else self.values.shape)

    def with_values(self, values):
        return HaloField(values, self.grid, self.bcs, self.shard_axes, self.axis_sizes)

    def pad(self, width: int) -> torch.Tensor:
        if self.bcs is None:
            raise ValueError("field has no boundary conditions")
        return _halo_pad(self.values, self.grid.ndim, self.bcs, self.shard_axes,
                         self.axis_sizes, width, 1 if self.is_vector else 0)


def _halo_pad(v, ndim, bcs, shard_axes, axis_sizes, width, lead=0):
    """Every spatial axis padded in order: the exchange on sharded axes, the
    local BC on the others."""
    for d in range(ndim):
        name = shard_axes[d]
        if name is None:
            v = _bc.pad_axis(v, bcs[d], d + lead, width)
        else:
            v = halo_pad_axis(v, d + lead, name, axis_sizes[d], bcs[d], width)
    return v


def mesh_layout(mesh: spmd.Mesh, ndim: int, max_axes=None):
    """``(shard_axes, axis_sizes)`` of a grid of ``ndim`` dimensions on
    ``mesh``: dimension ``d`` split over mesh axis ``d`` (the first
    ``max_axes`` only, when given)."""
    names = list(mesh.axis_names)[:ndim if max_axes is None else min(ndim, max_axes)]
    shard_axes = tuple(names[d] if d < len(names) else None for d in range(ndim))
    sizes = mesh.shape
    return shard_axes, tuple(sizes[a] if a else 1 for a in shard_axes)


def _split_coef(coef, mesh: spmd.Mesh, ndim: int, where: str):
    """A term coefficient's shards, as a function of the shard's coordinates:
    a ``MeshField`` (or its :class:`~.sharding.ShardedField`) or a tensor of
    the grid's shape cut to the shard's block, anything else as it is. A
    callable raises ``ValueError`` (``where`` names the term)."""
    if isinstance(coef, ShardedField):
        return lambda c: MeshField(coef.blocks[c], coef.grid, coef.bcs, _normalized=True)
    if isinstance(coef, MeshField):
        blocks = constrain(coef.values, mesh, ndim, coef.is_vector)
        return lambda c: MeshField(blocks[c], coef.grid, coef.bcs, _normalized=True)
    if isinstance(coef, torch.Tensor) and coef.ndim >= ndim:
        blocks = constrain(coef, mesh, ndim, coef.ndim == ndim + 1)
        return lambda c: blocks[c]
    if callable(coef):
        raise ValueError(
            f"{where}: a coefficient callable f(xs, t) would see the global grid's coordinates "
            "beside shard-local values; the sharded general path takes MeshFields, tensors "
            "and numbers (make_sharded_evolve(fused=True) evaluates callables per shard)")
    return lambda c: coef


def shard_terms(terms, mesh: spmd.Mesh, ndim: int, allow_callables: bool = False):
    """Each shard's terms, by coordinates: every coefficient cut to the
    shard (:func:`_split_coef`), ``update_func`` kept. With
    ``allow_callables`` a callable coefficient passes through as it is."""
    makers = []
    for n, term in enumerate(terms):
        where = f"term {n} ({type(term).__name__})"

        def split(coef):
            if coef is None or (allow_callables and callable(coef)):
                return lambda c: coef
            return _split_coef(coef, mesh, ndim, where)

        if isinstance(term, AdvectionTerm):
            u = split(term.velocity)
            makers.append(lambda c, tm=term, u=u: AdvectionTerm(u(c), tm.scheme, tm.update_func))
        elif isinstance(term, NormalMotionTerm):
            v = split(term.speed)
            makers.append(lambda c, tm=term, v=v: NormalMotionTerm(v(c), tm.update_func))
        elif isinstance(term, CurvatureTerm):
            b = split(term.b)
            makers.append(lambda c, b=b: CurvatureTerm(b(c)))
        elif isinstance(term, EikonalReinitializationTerm):
            s0 = split(term.s0)
            makers.append(lambda c, s0=s0: EikonalReinitializationTerm(s0(c)))
        else:
            raise TypeError(f"{where} is no term the sharded paths know")
    return {c: tuple(make(c) for make in makers) for c in mesh.coords()}


def local_field(phi: ShardedField, coord, grid: Grid, shard_axes, axis_sizes):
    """The shard ``coord`` of ``phi`` as a :class:`HaloField` (a
    :class:`~.evolve.ShardedNarrowBandField` for a band)."""
    if phi.is_band:
        from .evolve import ShardedNarrowBandField

        return ShardedNarrowBandField(phi.blocks[coord], grid, phi.bcs, phi.mask[coord],
                                      phi.nlayers, phi.cmask[coord], shard_axes, axis_sizes)
    return HaloField(phi.blocks[coord], grid, phi.bcs, shard_axes, axis_sizes)


def make_sharded_step(integrator, mesh: spmd.Mesh, grid: Grid):
    """A sharded step ``(terms, phi, t, dt) -> phi_new``.

    ``phi`` is a dense :class:`MeshField` or a :class:`NarrowBandField` (the
    masks shard as ordinary blocks; the masked update applies per shard), or
    a :class:`~.sharding.ShardedField` of either; the result is of the
    kind given. Coefficients in the terms are ``MeshField``s (or their
    shards), tensors or numbers, split alongside ``phi``; a callable raises
    ``ValueError`` naming its term. Each shard runs ``integrator.advance`` on
    its :class:`HaloField` in its own thread (:func:`~.spmd.run`).
    """
    ndim = grid.ndim
    shard_axes, axis_sizes = mesh_layout(mesh, ndim)

    def step(terms, phi, t, dt):
        terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
        sharded = isinstance(phi, ShardedField)
        sphi = shard_field(phi, mesh)
        local_terms = shard_terms(terms, mesh, ndim)

        def local(coord):
            hf = local_field(sphi, coord, grid, shard_axes, axis_sizes)
            out, _ = integrator.advance(local_terms[coord], hf, t, dt)
            return out.values

        blocks = spmd.run(mesh, local)
        out = sphi.with_blocks(blocks)
        return out if sharded else unshard(out, phi.values.device)

    return step
