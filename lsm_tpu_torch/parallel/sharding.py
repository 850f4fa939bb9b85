"""Domain decomposition of the level-set grid over an in-process mesh (port
of :mod:`lsm_tpu.parallel.sharding`).

The grid's leading dimensions are split over the mesh's axes, one mesh axis
per dimension, in order (:func:`domain_spec`); a vector field keeps its
component axis whole. :func:`shard_field` cuts a field into its shards, one
per mesh device, as a :class:`ShardedField`; :func:`unshard` puts them back
together. The explicit paths (:func:`~.halo.make_sharded_step`,
:func:`~.evolve.make_sharded_evolve`,
:func:`~.fused_evolve.make_sharded_fused_rollout`) take either.

JAX's auto-SPMD path (XLA's partitioner inserting the halo collectives into
any jitted step) has no PyTorch counterpart: :func:`constrain` places a
tensor on the mesh's canonical layout and nothing more, and the plain
engine given a :class:`ShardedField` raises ``TypeError``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.field import SHARDED_ONLY, MeshField
from ..core.narrowband import NarrowBandField
from .spmd import Mesh

__all__ = ["make_mesh", "mesh_axis_names", "domain_spec", "shard_field", "constrain",
           "unshard", "ShardedField"]

def _factorize(n: int, ndim: int) -> Tuple[int, ...]:
    """Split ``n`` devices into an ``ndim``-dim mesh shape, most-balanced first."""
    shape = [1] * ndim
    remaining = n
    for d in range(ndim):
        # greedy: largest divisor <= remaining^(1/(ndim-d))
        target = round(remaining ** (1.0 / (ndim - d)))
        best = 1
        for k in range(1, remaining + 1):
            if remaining % k == 0 and k <= max(target, 1):
                best = k
        shape[d] = best
        remaining //= best
    shape[-1] *= remaining
    return tuple(shape)


def mesh_axis_names(ndim: int) -> Tuple[str, ...]:
    return tuple("xyz"[d] if ndim <= 3 else f"d{d}" for d in range(ndim))


def make_mesh(n_devices: Optional[int] = None, mesh_shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None, devices=None) -> Mesh:
    """A device mesh for domain decomposition.

    ``devices`` (default: every CUDA device; none raises) may repeat a
    device: ``["cuda:0"] * 4`` puts four shards on one card, ``["cpu"] * 8``
    eight on the CPU. The CPU, and a repeated device, come only when the
    caller lists them. ``n_devices`` keeps the first that many. The shape
    defaults to a 2-axis mesh named ``("x", "y")`` (grids shard their two
    leading dimensions), factorised most-balanced first, as JAX's.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: make_mesh defaults to every card; pass "
                               'devices=["cpu"] * n for a mesh on the CPU')
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
        devices = devices[:n_devices]
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = _factorize(n, 2 if n > 1 else 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if math.prod(mesh_shape) != n:
        raise ValueError(f"mesh shape {mesh_shape} does not cover {n} devices")
    if axis_names is None:
        axis_names = mesh_axis_names(len(mesh_shape))
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(mesh_shape), tuple(axis_names))


def domain_spec(mesh: Mesh, grid_ndim: int, vector: bool = False) -> Tuple[Optional[str], ...]:
    """The mesh axis each dimension is split over (``None``: whole), the
    leading grid dimensions over the mesh axes in order (JAX's
    ``PartitionSpec``, as a tuple). Vector fields keep the component axis
    whole."""
    names = list(mesh.axis_names)[:grid_ndim]
    spec = names + [None] * (grid_ndim - len(names))
    if vector:
        spec = [None] + spec
    return tuple(spec)


def _block(mesh: Mesh, spec, shape, coord):
    """The index of ``coord``'s block of a tensor of ``shape`` split by
    ``spec``."""
    sizes = mesh.shape
    index = []
    for d, (name, n) in enumerate(zip(spec, shape)):
        if name is None:
            index.append(slice(None))
            continue
        s = sizes[name]
        if n % s:
            raise ValueError(f"dimension {d} of {n} nodes does not split over the {s} shards "
                             f"of mesh axis {name!r}")
        i = coord[mesh.axis_names.index(name)]
        index.append(slice(i * (n // s), (i + 1) * (n // s)))
    return tuple(index)


def constrain(values: torch.Tensor, mesh: Mesh, grid_ndim: int, vector: bool = False
              ) -> np.ndarray:
    """``values`` on the mesh's canonical layout: a numpy object array of the
    mesh's shape holding each shard's block on its device (a copy; autograd
    flows back to ``values``). Shards along a mesh axis that ``values`` is not
    split over hold the same block."""
    spec = domain_spec(mesh, grid_ndim, vector)
    out = np.empty(mesh.devices.shape, dtype=object)
    for c in mesh.coords():
        out[c] = values[_block(mesh, spec, values.shape, c)].to(mesh.device(c)).contiguous()
    return out


def _gather(blocks: np.ndarray, mesh: Mesh, spec, device) -> torch.Tensor:
    """The global tensor of ``blocks`` split by ``spec`` (the first shard's
    block along mesh axes the tensor is not split over), on ``device``."""
    split = [(d, mesh.axis_names.index(n)) for d, n in enumerate(spec) if n is not None]
    coord = [0] * blocks.ndim

    def cat(level):
        if level == len(split):
            return blocks[tuple(coord)].to(device)
        d, a = split[level]
        parts = []
        for i in range(blocks.shape[a]):
            coord[a] = i
            parts.append(cat(level + 1))
        coord[a] = 0
        return torch.cat(parts, dim=d)

    return cat(0)


class ShardedField:
    """A field split over a mesh: ``blocks`` holds each shard's values (a
    numpy object array of the mesh's shape, each block on its shard's
    device), a narrow band also its ``mask`` and ``cmask`` (compute mask)
    blocks; ``grid`` and ``bcs`` are the global field's. The plain engine
    does not take it (``values``, ``pad`` and ``with_values`` raise
    ``TypeError``)."""

    is_sharded = True

    def __init__(self, mesh: Mesh, grid, bcs, blocks, mask=None, cmask=None,
                 nlayers: Optional[int] = None):
        self.mesh, self.grid, self.bcs, self.blocks = mesh, grid, bcs, blocks
        self.mask, self.cmask, self.nlayers = mask, cmask, nlayers

    @property
    def is_band(self) -> bool:
        return self.mask is not None

    @property
    def ndim(self) -> int:
        return self.grid.ndim

    @property
    def shape(self):
        return self.grid.shape

    @property
    def is_vector(self) -> bool:
        return self.blocks.flat[0].ndim == self.grid.ndim + 1

    @property
    def dtype(self):
        return self.blocks.flat[0].dtype

    @property
    def values(self):
        raise TypeError(SHARDED_ONLY)

    def pad(self, width: int):
        raise TypeError(SHARDED_ONLY)

    def with_values(self, values):
        raise TypeError(SHARDED_ONLY)

    def with_blocks(self, blocks) -> "ShardedField":
        """The same field (its masks too) with new value blocks."""
        return ShardedField(self.mesh, self.grid, self.bcs, blocks, self.mask, self.cmask,
                            self.nlayers)

    def __repr__(self):
        kind = "band" if self.is_band else ("vector" if self.is_vector else "scalar")
        nodes = " x ".join(str(n) for n in self.shape)
        return f"ShardedField ({kind}, {self.dtype}, {nodes} nodes on {self.mesh})"


def shard_field(phi, mesh: Mesh) -> ShardedField:
    """A field's shards on the mesh's devices: its values (a vector field's
    component axis whole) and, for a :class:`NarrowBandField`, its active
    and compute masks. Differentiable: autograd flows back to
    ``phi.values``. A :class:`ShardedField` is returned as it is."""
    if isinstance(phi, ShardedField):
        return phi
    spec_nd = phi.grid.ndim
    blocks = constrain(phi.values, mesh, spec_nd, phi.is_vector)
    if isinstance(phi, NarrowBandField):
        return ShardedField(mesh, phi.grid, phi.bcs, blocks,
                            constrain(phi.mask, mesh, spec_nd),
                            constrain(phi.compute_mask, mesh, spec_nd), phi.nlayers)
    return ShardedField(mesh, phi.grid, phi.bcs, blocks)


def unshard(phi: ShardedField, device=None):
    """The global field of a :class:`ShardedField`, on ``device`` (default:
    the first shard's): a :class:`MeshField`, or a :class:`NarrowBandField`
    with the shards' masks. Differentiable."""
    mesh = phi.mesh
    device = mesh.devices.flat[0] if device is None else torch.device(device)
    spec = domain_spec(mesh, phi.ndim, phi.is_vector)
    values = _gather(phi.blocks, mesh, spec, device)
    if not phi.is_band:
        return MeshField(values, phi.grid, phi.bcs, _normalized=True)
    mspec = domain_spec(mesh, phi.ndim)
    return NarrowBandField(values, phi.grid, phi.bcs, _gather(phi.mask, mesh, mspec, device),
                           phi.nlayers, _normalized=True,
                           _cmask=_gather(phi.cmask, mesh, mspec, device))
