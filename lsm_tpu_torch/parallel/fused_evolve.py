"""Sharded fused evolution: the fused kernels per shard on an in-process mesh
(port of :mod:`lsm_tpu.parallel.fused_evolve`).

Each shard keeps its block of the grid in the port's padded layout
``(n0+6, n1+6, n2+6)`` (local extents). A stage is K1 (or K1′/K1″) on every
shard's buffer, with program coefficients evaluated at the shard's global
``origin`` (:class:`~lsm_tpu_torch.ops.weno_v2.Where`), then the sharded
ghost refresh :func:`refresh_ghosts_sharded`, in JAX's composition order:

- axis 0 (split over the mesh's first axis): the shells from the
  neighbours' interior edge rows (the ring exchange with the periodic
  duplicated-endpoint correction, as :func:`~.halo.halo_pad_axis`) or, on a
  physical face, the BC block of the shard's own edge rows, built in plain
  torch from O(N²) edge slabs, never a pass over the grid;
- axis 1 (split over the mesh's second axis): the same, from edge columns
  that already hold the fresh axis-0 ghosts (composed from the axis-0
  blocks and the interior columns, as JAX composes them);
- K9 (:func:`write_shell_blocks`, ``csrc/shell_blocks.cu``) writes those
  blocks into the buffer in one launch; an axis the mesh leaves whole takes
  K2's single-axis phase instead
  (:func:`~lsm_tpu_torch.ops.weno_v2.refresh_axis_fast`), and axis 2, never
  split, always does, over the full extent of axes 0 and 1.

The result equals :func:`~lsm_tpu_torch.ops.weno_v2.refresh_ghosts_plain`
of the global buffer bit for bit, and a sharded trajectory the
single-device fused one. The CFL bound is each shard's
:func:`~lsm_tpu_torch.terms.terms.compute_cfl` on its block, a callable
evaluated on its slice of the global axis coordinates (the ones the
single-device bound sees), then the minimum over the shards: the same bound
to the last bit.

The fused drivers own their loop, so they run the shards in lockstep from
the caller's thread: one stage on every shard, then the refresh over all of
them. Slabs that cross devices are peer copies.

The gradient (:func:`sharded_fused_step_stage`, :func:`make_sharded_fused_
rollout`): each stage is K1 per shard (``fused_step_stage(...,
refresh=False)``, whose backward is K3/K3′/K3″ at the shard's origin with K5
for ``daux``) and the refresh as one ``torch.autograd.Function`` over the
mesh. Its backward is the refresh's transpose: shell cotangents ride the
reversed exchange back to the neighbours' edge rows, physical faces fold
through the BC transpose, and the shells are zeroed; it is computed, as
JAX's, as the autograd VJP of the plain refresh at a zero primal. K3 reads
only the interior of its cotangent, so JAX's ``prefolded`` stage backward is
the stage backward without K4.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import bc as _bc
from ..core.field import MeshField
from ..core.grid import Grid
from ..equation import LevelSetEquation
from ..integrators.explicit import RK3
from ..integrators.fused import _STAGES, term_entries, unsupported_reason
from ..integrators.loop import _scan_steps
from ..ops import weno_v2 as v2
from ..ops._build import load_library
from ..ops._launches import bump
from ..terms.terms import compute_cfl
from . import spmd
from .halo import HaloField, mesh_layout, shard_terms
from .sharding import ShardedField, shard_field, unshard

__all__ = ["refresh_ghosts_sharded", "write_shell_blocks", "make_sharded_fused_evolve",
           "supports_sharded_fused", "sharded_fused_step_stage", "make_sharded_fused_rollout"]

_G = v2.GHOST
_EDGE = 8  # edge depth the BC blocks read: Extrapolation up to degree 7, deeper above


# -- K9: the shell writer ------------------------------------------------------------


def _block_slices(shape):
    """Where the four blocks of :func:`write_shell_blocks` go in the padded
    buffer: the axis-0 shells at the interior columns, the axis-1 shells over
    every row, both at the interior lanes."""
    n0, n1, n2 = shape
    lanes, cols = slice(_G, _G + n2), slice(_G, _G + n1)
    return ((slice(0, _G), cols, lanes), (slice(_G + n0, None), cols, lanes),
            (slice(None), slice(0, _G), lanes), (slice(None), slice(_G + n1, None), lanes))


def write_shell_blocks_plain(padded, l0, r0, l1, r1, shape) -> torch.Tensor:
    """Plain version of K9: slice assignment of the blocks given (``None``:
    not written). Returns ``padded``."""
    for sl, block in zip(_block_slices(shape), (l0, r0, l1, r1)):
        if block is not None:
            padded[sl] = block
    return padded


def write_shell_blocks(padded, l0, r0, l1, r1, shape) -> torch.Tensor:
    """K9: write ghost-shell blocks into a shard's padded buffer in place.

    ``l0``, ``r0``: the axis-0 shells, ``(3, n1, n2)``; ``l1``, ``r1``: the
    axis-1 shells, ``(n0+6, 3, n2)`` (over every row, so they carry the
    corner ghosts); each contiguous, of the buffer's dtype and device, or
    ``None`` (not written). The lane ghosts are left to K2's axis-2 phase.
    Replaces ``lsm_tpu.parallel.fused_evolve.write_shell_blocks``. CUDA
    tensors go to ``csrc/shell_blocks.cu`` (one launch), CPU tensors to
    :func:`write_shell_blocks_plain`. Returns ``padded``.
    """
    shape = tuple(shape)
    if len(shape) != 3:
        raise ValueError(f"the shell writer is 3D only, got shape {shape}")
    n0, n1, n2 = shape
    v2._check(padded, "padded", v2.padded_shape(shape))
    blocks = (l0, r0, l1, r1)
    shapes = ((_G, n1, n2),) * 2 + ((n0 + 2 * _G, _G, n2),) * 2
    for name, block, want in zip(("l0", "r0", "l1", "r1"), blocks, shapes):
        if block is not None:
            v2._check(block, name, want, like=padded)
    if padded.device.type == "cpu":
        return write_shell_blocks_plain(padded, *blocks, shape)
    lib = load_library()
    fn = lib.shell_blocks_f32 if padded.dtype == torch.float32 else lib.shell_blocks_f64
    with torch.cuda.device(padded.device):
        code = fn(padded.data_ptr(), *shape, *(None if b is None else b.data_ptr() for b in blocks),
                  torch.cuda.current_stream().cuda_stream)
    v2._raise_on(code, lib, "shell_blocks kernel")
    bump(write_shell_blocks, launches=1)
    return padded


write_shell_blocks.launches = 0


# -- the sharded ghost refresh ----------------------------------------------------------


class ShardLayout:
    """The fused path's view of a mesh and a 3D grid: dimensions 0 and 1
    split over the mesh's first two axes (every other mesh axis must have
    size 1), dimension 2 whole. ``coords`` the shards in order, ``sizes``
    the shard counts along dimensions 0 and 1, ``local_shape`` a shard's
    block, ``origins`` each shard's first node (index units), ``at[(i,
    j)]`` the shard at position ``(i, j)``."""

    def __init__(self, mesh: spmd.Mesh, grid: Grid):
        reason = _mesh_reason(mesh, grid)
        if reason is not None:
            raise ValueError(reason)
        self.mesh, self.grid = mesh, grid
        _, axis_sizes = mesh_layout(mesh, 3, max_axes=2)
        self.sizes = axis_sizes[:2]
        self.local_shape = tuple(n // s for n, s in zip(grid.shape, axis_sizes))
        self.coords = mesh.coords()
        self.pos = [tuple(c[a] if a < len(c) else 0 for a in (0, 1)) for c in self.coords]
        self.at = {p: k for k, p in enumerate(self.pos)}
        self.origins = [tuple(float(i * m) for i, m in zip(p, self.local_shape)) + (0.0,)
                        for p in self.pos]


def _mesh_reason(mesh: spmd.Mesh, grid: Grid) -> Optional[str]:
    """Why the fused path cannot split ``grid`` over ``mesh``: dimension 2
    stays whole (a third mesh axis of size > 1 would split it), dimensions
    0 and 1 split evenly."""
    if grid.ndim != 3:
        return f"the fused sharded path is 3D only, got a {grid.ndim}D grid"
    for name, s in list(mesh.shape.items())[2:]:
        if s > 1:
            return (f"mesh axis {name!r} of size {s} would split dimension 2, which the fused "
                    "sharded path keeps whole (it splits dimensions 0 and 1 only)")
    _, axis_sizes = mesh_layout(mesh, 3, max_axes=2)
    for d in range(2):
        if grid.shape[d] % axis_sizes[d]:
            return (f"dimension {d} of {grid.shape[d]} nodes does not split over "
                    f"{axis_sizes[d]} shards")
    return None


def _halo_blocks(first, last, axis, n_shards, bc_pair, layout, devices):
    """The ``(left, right)`` ghost shells (width 3) of one axis for every
    shard, from each shard's first and last edge slabs along ``axis``
    (``first[k]``, ``last[k]``, at least 4 deep): the ring exchange on
    interior faces with the periodic duplicated-endpoint correction, BC
    blocks on physical faces. Blocks are contiguous copies on the receiving
    shard's device."""
    left_bc, right_bc = bc_pair
    periodic = isinstance(left_bc, _bc.Periodic)
    d = 0 if axis == 0 else 1
    lefts, rights = [], []
    for k, pos in enumerate(layout.pos):
        idx = pos[d]

        def peer(j):
            p = list(pos)
            p[d] = j % n_shards
            return layout.at[tuple(p)]

        if idx == 0 and not periodic:
            left = _bc._ghost_block(first[k], left_bc, axis, _G, "left")
        else:  # the left neighbour's last rows; the last shard skips its duplicated endpoint
            src = last[peer(idx - 1)]
            w = src.shape[axis]
            left = src.narrow(axis, w - _G - 1 if idx == 0 else w - _G, _G)
        if idx == n_shards - 1 and not periodic:
            right = _bc._ghost_block(last[k], right_bc, axis, _G, "right")
        else:  # the right neighbour's first rows; shard 0 skips its duplicated endpoint
            right = first[peer(idx + 1)].narrow(axis, 1 if idx == n_shards - 1 else 0, _G)
        lefts.append(left.to(devices[k]).contiguous())
        rights.append(right.to(devices[k]).contiguous())
    return lefts, rights


def _refresh(bufs, bcs, layout: ShardLayout, plain: bool):
    """The sharded refresh of every shard's buffer in place (the module
    docstring's order); ``plain`` runs the plain versions of K9 and K2
    (differentiable under autograd, on a buffer autograd may write)."""
    shape = layout.local_shape
    n0, n1, n2 = shape
    s0, s1 = layout.sizes
    axis_phase = v2.refresh_axis_plain if plain else v2.refresh_axis_fast
    write = write_shell_blocks_plain if plain else write_shell_blocks
    devices = [b.device for b in bufs]
    lanes = slice(_G, _G + n2)
    edge = [max([_EDGE] + [b.degree + 1 for b in pair if isinstance(b, _bc.Extrapolation)])
            for pair in bcs[:2]]
    w0, w1 = min(edge[0], n0), min(edge[1], n1)
    none = [None] * len(bufs)
    l0 = r0 = l1 = r1 = none
    if s0 > 1:
        l0, r0 = _halo_blocks([b[_G:_G + w0, _G:_G + n1, lanes] for b in bufs],
                              [b[_G + n0 - w0:_G + n0, _G:_G + n1, lanes] for b in bufs],
                              0, s0, bcs[0], layout, devices)
    else:
        for b in bufs:
            axis_phase(b, bcs, shape, 0)
    if s1 > 1:
        def edge(b, k, c0):
            """Columns [c0, c0 + w1) over every row, the axis-0 ghosts fresh."""
            if s0 == 1:  # K2's axis-0 phase has written them into the buffer
                return b[:, _G + c0:_G + c0 + w1, lanes]
            return torch.cat([l0[k][:, c0:c0 + w1], b[_G:_G + n0, _G + c0:_G + c0 + w1, lanes],
                              r0[k][:, c0:c0 + w1]], dim=0)

        l1, r1 = _halo_blocks([edge(b, k, 0) for k, b in enumerate(bufs)],
                              [edge(b, k, n1 - w1) for k, b in enumerate(bufs)],
                              1, s1, bcs[1], layout, devices)
    for k, b in enumerate(bufs):
        write(b, l0[k], r0[k], l1[k], r1[k], shape)
    if s1 == 1:
        for b in bufs:
            axis_phase(b, bcs, shape, 1)
    for b in bufs:
        axis_phase(b, bcs, shape, 2)
    return bufs


def refresh_ghosts_sharded(bufs, bcs, layout: ShardLayout):
    """The sharded ghost refresh of every shard's padded buffer (a list in
    ``layout.coords`` order), in place: the exchanged and BC blocks of the
    split axes by K9, the whole axes by K2's single-axis phase (the
    counterpart of ``lsm_tpu.parallel.fused_evolve.refresh_ghosts_sharded``,
    the mesh's shards at once). A mesh of one shard takes K2 whole. CUDA
    buffers go to the kernels, CPU buffers to their plain versions. Returns
    ``bufs``."""
    if layout.sizes == (1, 1):
        for b in bufs:
            v2.refresh_ghosts_fast(b, bcs, layout.local_shape)
        return bufs
    return _refresh(list(bufs), bcs, layout, plain=False)


def refresh_sharded_transpose(gs, bcs, layout: ShardLayout):
    """The transpose of the sharded refresh applied to the cotangents ``gs``
    (one per shard): the autograd VJP of its plain version at a zero primal
    (the refresh is linear). Shell cotangents land on the edge rows they
    were built from, on this shard or its neighbours; the shells come back
    zero."""
    with torch.enable_grad():
        zeros = [torch.zeros_like(g, requires_grad=True) for g in gs]
        outs = [z.clone() for z in zeros]
        if layout.sizes == (1, 1):
            for o in outs:
                v2.refresh_ghosts_plain(o, bcs, layout.local_shape)
        else:
            _refresh(outs, bcs, layout, plain=True)
        return torch.autograd.grad(outs, zeros, grad_outputs=list(gs))


class _ShardedRefresh(torch.autograd.Function):
    """The sharded refresh over every shard's buffer, in place (forward K9 and
    K2's phases); backward :func:`refresh_sharded_transpose`."""

    @staticmethod
    def forward(ctx, statics, *bufs):
        bcs, layout = statics
        refresh_ghosts_sharded(list(bufs), bcs, layout)
        ctx.mark_dirty(*bufs)
        ctx.statics = statics
        return bufs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        bcs, layout = ctx.statics
        return (None, *refresh_sharded_transpose(gs, bcs, layout))


def _refresh_maybe_grad(bufs, bcs, layout):
    if torch.is_grad_enabled() and any(b.requires_grad for b in bufs):
        return list(_ShardedRefresh.apply((bcs, layout), *bufs))
    return refresh_ghosts_sharded(list(bufs), bcs, layout)


def sharded_fused_step_stage(Ps, terms, coeffs, auxs, bcs, spacing, lo, layout: ShardLayout,
                             t=0.0, coeff_values=None, t_value=None):
    """One fused RK stage plus the sharded ghost refresh on every shard's
    padded buffer (``Ps``, ``auxs`` and ``terms`` lists in ``layout.coords``
    order, ``terms[k]`` shard ``k``'s ``(TermSpec, streams)`` list),
    differentiable (the counterpart of
    ``lsm_tpu.parallel.fused_evolve.sharded_fused_step_stage``, every shard
    at once). Forward: K1 per shard at its origin, then K9 and K2's phases;
    backward: the refresh's transpose, then K3/K3′/K3″ per shard and K5 for
    ``daux``. ``coeffs`` and ``t`` as for
    :func:`~lsm_tpu_torch.ops.weno_v2.fused_step_stage`. Returns the new
    buffers."""
    shape = layout.local_shape
    outs = [v2.fused_step_stage(P, tm, coeffs, aux, bcs, spacing, shape, coeff_values,
                                v2.Where(lo, origin, t, t_value), refresh=False)
            for P, tm, aux, origin in zip(Ps, terms, auxs, layout.origins)]
    return _refresh_maybe_grad(outs, bcs, layout)


# -- the drivers -------------------------------------------------------------------------


class _ShardGrid:
    """A shard's view of the global grid for the CFL bound: the global
    spacing, the local shape, and the shard's slice of the global axis
    coordinates (the values the single-device bound evaluates a callable
    at)."""

    def __init__(self, grid: Grid, origin, shape):
        self.grid, self.shape = grid, tuple(shape)
        self.start = tuple(int(o) for o in origin)
        self.ndim, self.spacing, self.min_spacing = grid.ndim, grid.spacing, grid.min_spacing

    def coords(self, dtype=torch.float64, device=None):
        out = []
        for d, (s, n) in enumerate(zip(self.start, self.shape)):
            view = [1] * self.ndim
            view[d] = n
            out.append(self.grid.axis_coords(d, dtype, device)[s:s + n].reshape(view))
        return tuple(out)


def _prepare(terms, phi, mesh: spmd.Mesh, integrator, place=False):
    """``(reason, local, sphi)``: why the fused sharded path cannot take
    ``(terms, phi)`` on ``mesh`` (``None`` when it can) and, when it can,
    every shard's terms (callables kept) and its block as a
    :class:`~.halo.HaloField`. With ``place`` the blocks are ``sphi``, the
    field's shards on the mesh; without, a global field's blocks are views
    of its values (nothing copied) and ``sphi`` is ``None``."""
    if (phi.is_band if isinstance(phi, ShardedField) else phi.active_mask is not None):
        return "the fused sharded path is dense-only", None, None
    reason = _mesh_reason(mesh, phi.grid)
    if reason is not None:
        return reason, None, None
    for n, term in enumerate(terms):
        if getattr(term, "update_func", None) is not None:
            return (f"term {n} ({type(term).__name__}) has an update_func, which the fused "
                    "sharded path does not take (as JAX's)"), None, None
    layout = ShardLayout(mesh, phi.grid)
    sphi = shard_field(phi, mesh) if place or isinstance(phi, ShardedField) else None
    if sphi is not None:
        blocks = [sphi.blocks[c] for c in layout.coords]
    else:
        m0, m1, _ = layout.local_shape
        blocks = [phi.values[i * m0:(i + 1) * m0, j * m1:(j + 1) * m1] for i, j in layout.pos]
    per = shard_terms(terms, mesh, 3, allow_callables=True)
    shard_axes, axis_sizes = mesh_layout(mesh, 3, max_axes=2)
    local = [(per[c], HaloField(b, phi.grid, phi.bcs, shard_axes, axis_sizes))
             for c, b in zip(layout.coords, blocks)]
    for c, (tms, hf) in zip(layout.coords, local):
        reason = unsupported_reason(tms, hf, integrator)
        if reason is not None:
            return f"shard {c} of local shape {layout.local_shape}: {reason}", None, None
    return None, local, sphi


def sharded_fused_reason(terms, phi, mesh: spmd.Mesh, integrator=None) -> Optional[str]:
    """Why the fused sharded path cannot take ``(terms, phi)`` on ``mesh``;
    ``None`` when it can: a dense 3D field (or its shards) whose dimensions
    0 and 1 split evenly over the mesh's first two axes (dimension 2 whole),
    terms the fused stepper takes without ``update_func``, and each shard's
    block what K1 and K2 take (per axis at least 4 nodes, and the degree + 1
    an ``Extrapolation`` reads; K2's rules, on the local shape)."""
    terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
    return _prepare(terms, phi, mesh, integrator or RK3())[0]


def supports_sharded_fused(terms, phi, mesh: spmd.Mesh) -> bool:
    """Whether the fused sharded path takes ``(terms, phi)`` on ``mesh``
    (:func:`sharded_fused_reason`)."""
    return sharded_fused_reason(terms, phi, mesh) is None


class _Sharded:
    """What a fused sharded driver builds per call: the shards' terms, fields
    and stage entries, and the shard grids of the CFL bound."""

    def __init__(self, terms, phi, layout: ShardLayout, integrator):
        terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
        reason, local, self.sphi = _prepare(terms, phi, layout.mesh, integrator, place=True)
        if reason is not None:
            raise ValueError(reason)
        self.layout, self.bcs, self.dtype = layout, phi.bcs, phi.dtype
        self.terms = [tms for tms, _ in local]
        self.entries = [term_entries(tms, hf) for tms, hf in local]
        self.grids = [_ShardGrid(layout.grid, o, layout.local_shape) for o in layout.origins]
        self.spacing = tuple(float(h) for h in layout.grid.spacing)
        self.lo = tuple(float(x) for x in layout.grid.lo)
        self.stages = _STAGES[type(integrator)]

    def pack(self):
        return _refresh_maybe_grad([v2.pack_padded(self.sphi.blocks[c], self.bcs)
                                    for c in self.layout.coords], self.bcs, self.layout)

    def stage_terms(self, t):
        """Each shard's stage terms at time ``t``: a callable on the stream
        route evaluated at the shard's node coordinates."""
        out = []
        for entries, origin in zip(self.entries, self.layout.origins):
            if any(spec.coef_kind == "analytic" for spec, _ in entries):
                like = self.sphi.blocks.flat[0]
                xs = v2.node_coords(self.layout.local_shape, self.spacing, self.lo, self.dtype,
                                    like.device, origin)
                entries = v2.resolve_terms(entries, xs, t, self.layout.local_shape, self.dtype,
                                           like.device)
            out.append(entries)
        return out

    def step(self, Ps, t, dt, dt_value):
        """One accepted step on every shard (the stepper's SSP stages)."""
        tv = float(t.detach()) if isinstance(t, torch.Tensor) else float(t)
        cur = Ps
        for s, (alpha, beta, g, off) in enumerate(self.stages):
            cur = sharded_fused_step_stage(
                cur, self.stage_terms(t + off * dt), (alpha, beta, g * dt),
                [None] * len(Ps) if s == 0 else Ps, self.bcs, self.spacing, self.lo,
                self.layout, t + off * dt, (alpha, beta, g * dt_value), tv + off * dt_value)
        return cur

    def cfl(self, Ps, t) -> float:
        """The global CFL bound (a host number): each shard's bound on its
        block, then the minimum."""
        shape = self.layout.local_shape
        bounds = [compute_cfl(tms, MeshField(v2.unpack_padded(P, shape), grid, self.bcs,
                                             _normalized=True), t)
                  for tms, P, grid in zip(self.terms, Ps, self.grids)]
        dev = bounds[0].device
        return LevelSetEquation._checked_dt(
            torch.stack([b.to(dev) for b in bounds]).min().item())

    def result(self, Ps, phi):
        shape = self.layout.local_shape
        blocks = self.sphi.blocks.copy()
        for c, P in zip(self.layout.coords, Ps):
            blocks[c] = v2.unpack_padded(P, shape).contiguous()
        out = self.sphi.with_blocks(blocks)
        return out if isinstance(phi, ShardedField) else unshard(out, phi.values.device)


def _check_integrator(integrator):
    if type(integrator) not in _STAGES:
        raise ValueError(f"unsupported integrator {type(integrator).__name__}: the fused "
                         "sharded path takes ForwardEuler, RK2 and RK3")


def make_sharded_fused_evolve(integrator, mesh: spmd.Mesh, grid: Grid, dt_max=math.inf,
                              max_steps: Optional[int] = None):
    """A sharded adaptive evolution on the fused kernels, ``(terms, phi, t0,
    tf) -> (phi, t, nsteps)`` (the signature of
    :func:`~.evolve.make_sharded_evolve`; ``phi`` a dense 3D
    :class:`MeshField` or its :class:`~.sharding.ShardedField`, the result
    of the kind given).

    Each shard keeps its block in the padded layout; every stage is K1 per
    shard and the sharded refresh (K9, K2's phases); the CFL bound is the
    minimum of the shards' bounds, read back once per step, so every shard
    takes the same ``dt``. The loop is ``LevelSetEquation.integrate``'s
    fused loop and matches the single-device trajectory. What the path does
    not take (:func:`sharded_fused_reason`) raises ``ValueError`` with the
    reason, on every device.
    """
    _check_integrator(integrator)
    layout = ShardLayout(mesh, grid)

    def evolve_fn(terms, phi, t0, tf):
        run = _Sharded(terms, phi, layout, integrator)
        tf = float(tf)
        eps = torch.finfo(run.dtype).eps * max(abs(tf), 1.0)
        Ps, t, n = run.pack(), float(t0), 0
        while t <= tf - eps and (max_steps is None or n < max_steps):
            dt = min(dt_max, integrator.cfl * run.cfl(Ps, t), tf - t)
            Ps = run.step(Ps, t, dt, dt)
            t += dt
            n += 1
        return run.result(Ps, phi), (tf if t > tf - eps else t), n

    return evolve_fn


def make_sharded_fused_rollout(integrator, mesh: spmd.Mesh, grid: Grid, nsteps: int,
                               remat: bool = True):
    """A differentiable fixed-step sharded rollout on the fused kernels:
    ``(terms, phi, t0, dt) -> phi`` after ``nsteps`` steps of size ``dt``
    (the sharded counterpart of :func:`~lsm_tpu_torch.integrators.loop.
    rollout`'s fused path; ``phi`` a dense 3D :class:`MeshField` or its
    shards, the result of the kind given).

    Every stage is :func:`sharded_fused_step_stage`; ``remat`` wraps each
    step in ``torch.utils.checkpoint``. Gradients flow to ``phi.values``,
    streamed coefficients and tensor ``t0``/``dt`` (a tensor ``dt`` is read
    back once), and match the single-device rollout's."""
    _check_integrator(integrator)
    layout = ShardLayout(mesh, grid)
    nsteps = int(nsteps)

    def rollout_fn(terms, phi, t0, dt):
        run = _Sharded(terms, phi, layout, integrator)
        dt_value = float(dt.detach()) if isinstance(dt, torch.Tensor) else float(dt)
        k = len(layout.coords)

        def step(c):
            return (*run.step(list(c[:k]), c[k], dt, dt_value), c[k] + dt)

        carry = _scan_steps(step, (*run.pack(), t0), nsteps, remat, None)
        return run.result(list(carry[:k]), phi)

    return rollout_fn
