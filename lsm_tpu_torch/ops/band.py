"""Active-tile narrow-band kernels and their layout helpers (port of
:mod:`lsm_tpu.ops.band_pallas`).

Layout: the band's phi buffers use the dense path's padded
``(n0+6, n1+6, n2+6)`` layout (:func:`~lsm_tpu_torch.ops.weno_v2.pack_padded`
/ ``unpack_padded``); the TPU layout's junk rows, 128-lane pads and pitch fix
are TPU constraints and are not kept. The band itself is one interior-shaped
``uint8`` *combined mask*: 0 outside, 1 compute band only, 2 active band.
The grid is cut into tiles ``(B0, B1, B2)``; the tile grid is
``ceil(n / B)`` per axis, so a ragged edge tile is allowed. A *dispatch list*
holds the flat (row-major) ids of the tiles a stage visits, ``-1`` in empty
slots; per-slot data (each term's streamed coefficients, the active mask
the CFL bound reduces over) is *tile-packed* as ``(capacity, B0, B1, B2)``.

Kernels, each beside its plain torch version (CPU tensors, the tests, and
the on-card comparison in ``chip_smoke.py``):

- :func:`band_stage` (K6, ``csrc/band_stage.cu``; plain
  :func:`band_stage_plain`): K1's stage, any term list, over the dispatched
  tiles, into the ping-pong target; cells outside the compute band keep the
  source's value. A program term (K6″) is evaluated per node at the node's
  own coordinates: it needs no tile-packed stream and no coordinates kept
  per slot.
- :func:`refresh_band_ghosts_fast` (K7, ``csrc/refresh_ghosts.cu``; plain
  :func:`refresh_band_ghosts_plain`): K2's one-launch shell refresh, its
  phases gated by device flags.
- :func:`band_retube_incremental` (K8, ``csrc/band_retube.cu``; plain
  :func:`band_retube_plain`): the re-tube recomputed on candidate tiles only.
- :func:`band_step_stage` is K6 + K7 as a ``torch.autograd.Function`` into
  a fresh buffer, whose backward is autograd of the plain composite
  :func:`band_stage_refresh_plain` (JAX's band stage is a ``custom_vjp``
  whose backward is ``jax.vjp`` of its dense composite: there is no TPU
  kernel of the band adjoint).

A 2D band keeps its own padded ``(n0+6, n1+6)`` layout, the uint8 mask
``(n0, n1)``, tiles ``(B0, B1)`` over the tile grid ``(G0, G1)`` and streams
packed ``(capacity, B0, B1)``; every function here takes either. The 2D
stage computes JAX's 2D band function, the 3D stage of the ``(1, n0, n1)``
embedding (``lsm_tpu.integrators.band_fused``), so its term list is the
embedding's as :func:`~lsm_tpu_torch.integrators.fused.term_entries` gives
it for a 2D field (an advection velocity of three components, the first
zero; programs of the three embedding coordinates), while ``spacing`` and
``where`` are the 2D field's (the embedding's dummy axis takes the smallest
spacing, so the eikonal smoothing reads ``min(spacing)`` of the field, and
coordinate 0). The kernels' 2D entries run it with axis 0 compiled out; the
plain versions run the 2D stage of the plain stencils, whose sums skip the
embedding's exact-zero axis-0 terms.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises, and counts its launches in ``launches`` (K6
also those of its term-list entry in ``kinds_launches`` and those with a
program term in ``program_launches``). The
dispatch-list compaction is plain torch on the device (a ``cumsum`` and a
scatter), with no host synchronisation.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.narrowband import band_mask_from_values, box_dilate
from . import weno_v2 as v2
from .weno_v2 import embedding_2d
from ._build import load_library
from ._launches import bump

__all__ = [
    "tile_grid",
    "tile_activity",
    "compact_ids",
    "active_tile_ids",
    "scatter_activity",
    "refresh_flags_from_activity",
    "tile_index",
    "tile_coords",
    "dispatched_cells",
    "band_stage_plain",
    "band_stage",
    "band_stage_reference",
    "band_stage_refresh_plain",
    "band_step_stage",
    "refresh_band_ghosts_plain",
    "refresh_band_ghosts_fast",
    "retube_full",
    "band_retube_plain",
    "band_retube_incremental",
]

GHOST = v2.GHOST
ACTIVE = 2  # the active band's value in the combined mask
BOX_BYTES = 227 * 1024  # shared memory a block may take on the card (K6's box)


def tile_grid(shape, tiles) -> Tuple[int, ...]:
    """Tiles per axis, ``ceil(n / B)``."""
    return tuple(-(-n // b) for n, b in zip(shape, tiles))


def tile_activity(compute_mask: torch.Tensor, tiles) -> torch.Tensor:
    """``(G0, G1[, G2])`` bool: does the tile hold any compute-band node?"""
    G = tile_grid(compute_mask.shape, tiles)
    m = (compute_mask != 0).to(torch.uint8)
    pad = []
    for n, g, b in reversed(list(zip(compute_mask.shape, G, tiles))):
        pad += [0, g * b - n]
    m = F.pad(m, pad)
    m = m.reshape([x for g, b in zip(G, tiles) for x in (g, b)])
    return m.amax(dim=tuple(range(1, 2 * len(G), 2))) != 0


def compact_ids(flags: torch.Tensor, capacity: int):
    """The flat indices of the set entries of ``flags``, in order, in an
    ``int32[capacity]`` list padded with -1, and their number (an int32 0-d
    tensor; more than ``capacity`` means the list overflowed and holds the
    first ``capacity``). A ``cumsum`` and a scatter on the device: no host
    synchronisation (``torch.nonzero`` would need one)."""
    flat = flags.reshape(-1)
    pos = torch.cumsum(flat.to(torch.int32), 0, dtype=torch.int32)
    count = pos[-1]
    keep = flat & (pos <= capacity)
    target = torch.where(keep, pos - 1, capacity).long()
    ids = torch.full((capacity + 1,), -1, dtype=torch.int32, device=flat.device)
    ids.scatter_(0, target, torch.arange(flat.numel(), dtype=torch.int32, device=flat.device))
    return ids[:capacity], count


def active_tile_ids(compute_mask: torch.Tensor, tiles, capacity: int):
    """``(ids, count)`` of the tiles holding compute-band nodes
    (:func:`compact_ids` of :func:`tile_activity`)."""
    return compact_ids(tile_activity(compute_mask, tiles), capacity)


def scatter_activity(act: torch.Tensor, cids: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """The tile activity grid ``act`` with the entry of every candidate tile
    of ``cids`` (-1: an empty slot) replaced by its re-tube flag."""
    n = act.numel()
    flat = torch.cat([act.reshape(-1), torch.zeros(1, dtype=torch.bool, device=act.device)])
    flat[torch.where(cids >= 0, cids, n).long()] = flags != 0
    return flat[:-1].reshape(act.shape)


def refresh_flags_from_activity(act: torch.Tensor, layers=None) -> torch.Tensor:
    """``int32[2]`` gates for :func:`refresh_band_ghosts_fast` from a tile
    activity grid: a ghost shell changes only when a visited tile touches its
    face. ``layers[d] = (lo, hi)`` is how many tile layers at each face of
    axis ``d`` hold the nodes the ghosts are built from (default 1: a tile
    at least that deep). 3D: ``flags[0]`` gates axes 0 and 1; ``flags[1]``
    gates axis 2 and includes ``flags[0]``: the axis-2 ghosts of the axis-0/1
    ghost rows read those rows. 2D: ``flags[0]`` gates axis 0, ``flags[1]``
    axis 1 and includes ``flags[0]``, for the same reason."""
    a = act != 0
    layers = ((1, 1),) * a.ndim if layers is None else layers

    def face(ax):
        lo, hi = layers[ax]
        n = a.shape[ax]
        return a.narrow(ax, 0, min(lo, n)).any() | a.narrow(ax, n - min(hi, n), min(hi, n)).any()

    if a.ndim == 2:
        f0 = face(0)
        return torch.stack([f0, face(1) | f0]).to(torch.int32)
    f01 = face(0) | face(1)
    return torch.stack([f01, face(2) | f01]).to(torch.int32)


def _tile_axes(ids: torch.Tensor, shape, tiles):
    """Per axis, the node indices of the dispatched tiles, int64 shaped
    ``(capacity, B0, 1, 1)``, ``(capacity, 1, B1, 1)``, ``(capacity, 1, 1,
    B2)`` (2D: ``(capacity, B0, 1)``, ``(capacity, 1, B1)``; an empty slot
    decodes as tile 0; a ragged edge runs past ``n``)."""
    G = tile_grid(shape, tiles)
    nd = len(G)
    rest = ids.clamp(min=0).long()
    tile = [None] * nd
    for d in reversed(range(nd)):  # row-major over the tile grid
        tile[d], rest = rest % G[d], rest // G[d]
    out = []
    for d in range(nd):
        view = [-1] + [1] * nd
        view[1 + d] = tiles[d]
        out.append((tile[d][:, None] * tiles[d] + torch.arange(tiles[d], device=ids.device))
                   .reshape(view))
    return out


def tile_index(ids: torch.Tensor, shape, tiles):
    """Per dispatch slot and tile node: ``(flat, valid)``, both
    ``(capacity, *tiles)``; ``flat`` the node's row-major index in the
    interior (clamped to the grid), ``valid`` false for empty slots and nodes
    past a ragged edge."""
    idx = _tile_axes(ids, shape, tiles)
    valid = (ids >= 0).reshape([-1] + [1] * len(idx))
    flat = 0
    for d, i in enumerate(idx):
        valid = valid & (i < shape[d])
        flat = flat * shape[d] + i.clamp(max=shape[d] - 1)
    return flat, valid


def tile_coords(ids: torch.Tensor, shape, tiles, spacing, lo, dtype):
    """Broadcastable node coordinates ``lo + i*h`` of the dispatched tiles
    (shapes as :func:`_tile_axes`): the coordinates K1 evaluates a callable
    velocity at (:func:`~lsm_tpu_torch.ops.weno_v2.node_coords`), per slot."""
    return tuple(lo[d] + i.to(dtype) * float(spacing[d])
                 for d, i in enumerate(_tile_axes(ids, shape, tiles)))


def dispatched_cells(ids: torch.Tensor, shape, tiles) -> torch.Tensor:
    """Interior-shaped bool: the nodes of the tiles on the dispatch list."""
    G = tile_grid(shape, tiles)
    total = math.prod(G)
    disp = torch.zeros(total + 1, dtype=torch.bool, device=ids.device)
    disp[torch.where(ids >= 0, ids, total).long()] = True
    cells = disp[:-1].reshape(G)
    for d in range(len(G)):
        cells = cells.repeat_interleave(tiles[d], dim=d)
    return cells[tuple(slice(0, n) for n in shape)]


# -- argument checks ------------------------------------------------------------------


def _check_ids(ids: torch.Tensor, name: str, like: torch.Tensor):
    if ids.dtype != torch.int32 or ids.ndim != 1 or not ids.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    if ids.device != like.device:
        raise ValueError(f"{name} lies on {ids.device}, the state on {like.device}")


def _check_band(band: torch.Tensor, shape, like: torch.Tensor):
    if band.dtype != torch.uint8 or tuple(band.shape) != tuple(shape) or not band.is_contiguous():
        raise ValueError(f"band must be a contiguous uint8 tensor of shape {tuple(shape)}")
    if band.device != like.device:
        raise ValueError(f"band lies on {band.device}, the state on {like.device}")


def _check_tiles(shape, tiles):
    if len(shape) not in (2, 3) or len(tiles) != len(shape) or any(int(b) < 1 for b in tiles):
        raise ValueError(f"the band kernels take a 2D or 3D shape with one positive tile size "
                         f"per axis, got {shape}, {tiles}")


# -- the 2D band: the (1, n0, n1) embedding's term list on the 2D layout -------------


def dense_terms(terms, shape, spacing, where: Optional[v2.Where], like: torch.Tensor, dense):
    """A band stage's term list for the plain stencils, each stream through
    ``dense`` (tile-packed to grid-shaped). A 2D band's (the embedding's)
    becomes 2D: a program is evaluated at the embedding's nodes of
    ``shape`` (its graph kept for a tensor ``where.t``) into a stream
    (:func:`~lsm_tpu_torch.ops.weno_v2.programs_2d`), an advection term
    loses its zero component 0. Constant and sign-recomputing terms pass
    through."""
    if len(shape) != 2:
        return tuple((spec, tuple(dense(a) for a in arrs)) for spec, arrs in terms)
    out = []
    for spec, arrs in terms:
        if spec.coef_kind == "stream":
            arrs = tuple(dense(a) for a in arrs)
            if spec.kind == "advection":
                arrs = arrs[1:]
            spec = v2.TermSpec(spec.kind, "stream", None, len(arrs))
        out.append((spec, tuple(arrs)))
    return v2.programs_2d(out, shape, spacing, where, like)


# -- K6: the active-tile stage ---------------------------------------------------------


def _as_band_terms(terms, shape):
    """A band stage's normalised term list: velocity tensors, one per axis,
    stand for one streamed advection term (a 2D band's gain the
    embedding's zero component 0)."""
    terms = tuple(terms)
    if terms and all(isinstance(x, torch.Tensor) for x in terms):
        if len(terms) != len(shape):
            raise ValueError(f"the band stage needs {len(shape)} velocity components")
        if len(shape) == 2:
            terms = (torch.zeros_like(terms[0]), *terms)
    return v2.as_terms(terms)


def band_stage_plain(P, out, ids, band, terms, coeffs, aux, spacing, shape, tiles,
                     where: Optional[v2.Where] = None) -> torch.Tensor:
    """Plain version of K6: the dense stage (each tile-packed stream
    scattered onto the grid, each program evaluated at ``where``), then
    ``torch.where`` to (dispatched tile and compute band); other nodes of a
    dispatched tile take ``P``'s value, the rest of ``out`` is left as it
    is. Writes ``out`` in place, returns it."""
    flat, valid = tile_index(ids, shape, tiles)

    def dense(packed):
        d = torch.zeros(shape, dtype=P.dtype, device=P.device)
        d.view(-1)[flat[valid]] = packed[valid]
        return d

    terms = dense_terms(_as_band_terms(terms, shape), shape, spacing, where, P, dense)
    stage = v2._stage_interior(P, terms, coeffs, aux, spacing, shape, where)
    new = torch.where(band != 0, stage, v2.unpack_padded(P, shape))
    o = v2.unpack_padded(out, shape)
    o.copy_(torch.where(dispatched_cells(ids, shape, tiles), new, o))
    return out


def band_stage(P: torch.Tensor, out: torch.Tensor, ids: torch.Tensor, band: torch.Tensor,
               terms, coeffs, aux: Optional[torch.Tensor], spacing, shape,
               tiles, where: Optional[v2.Where] = None) -> torch.Tensor:
    """K6: one RK stage on the dispatched tiles.

    Replaces ``lsm_tpu.ops.band_pallas.band_stage``. ``P`` the source and
    ``out`` the ping-pong target (padded buffers, written in place and
    returned; ghost shells untouched), ``ids`` the int32 dispatch list,
    ``band`` the uint8 combined mask, ``terms`` K1's term list (or three
    velocity tensors) with every stream tile-packed ``(capacity, *tiles)``,
    ``aux`` a padded buffer or None, ``coeffs`` ``(alpha, beta,
    gamma)`` as numbers; program terms (K6″) at ``where`` as in
    :func:`~lsm_tpu_torch.ops.weno_v2.fused_stage`. A 2D band (module
    docstring) takes the embedding's term list, or its two velocity tensors.
    CUDA tensors go to ``csrc/band_stage.cu`` (the advection-only stage to
    its own entries, a 2D band to the 2D entries; each block stages its
    tile's box of ``P``, ``tiles + 6`` per axis, in shared memory, and a tile
    whose box does not fit is refused), CPU tensors to
    :func:`band_stage_plain`.
    """
    shape, tiles = tuple(shape), tuple(int(b) for b in tiles)
    _check_tiles(shape, tiles)
    v2._check(P, "P", v2.padded_shape(shape))
    v2._check(out, "out", v2.padded_shape(shape), like=P)
    if out.data_ptr() == P.data_ptr():
        raise ValueError("the band stage writes a ping-pong target: out must not be P")
    _check_ids(ids, "ids", P)
    _check_band(band, shape, P)
    terms = _as_band_terms(terms, shape)
    v2.check_terms(terms, P, (ids.shape[0], *tiles))
    if aux is not None:
        v2._check(aux, "aux", v2.padded_shape(shape), like=P)
    where = where or v2.Where()
    if P.device.type == "cpu":
        return band_stage_plain(P, out, ids, band, terms, coeffs, aux, spacing, shape, tiles,
                                where)
    box = math.prod(b + 2 * GHOST for b in tiles[-2:]) * (tiles[0] + 2 * GHOST if len(shape) == 3
                                                          else 1)
    if (box + 3 * tiles[0]) * P.element_size() > BOX_BYTES:
        raise ValueError(f"tiles {tiles}: K6 stages a tile's box of {box} nodes of phi in "
                         f"shared memory, over a block's {BOX_BYTES} bytes in {P.dtype}")
    lib = load_library()
    f32 = P.dtype == torch.float32
    aux_ptr = None if aux is None else aux.data_ptr()
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream().cuda_stream
        if len(shape) == 2:
            code = _band_stage_2d(lib, f32, P, aux_ptr, out, ids, band, terms, coeffs, spacing,
                                  shape, tiles, where, stream)
        elif v2.is_advection_only(terms) and terms[0][0].coef_kind == "stream":
            u = terms[0][1]
            alpha, beta, gamma = (float(c) for c in coeffs)
            code = (lib.band_stage_f32 if f32 else lib.band_stage_f64)(
                P.data_ptr(), u[0].data_ptr(), u[1].data_ptr(), u[2].data_ptr(), aux_ptr,
                out.data_ptr(), band.data_ptr(), ids.data_ptr(), ids.shape[0], *shape, *tiles,
                *(1.0 / float(h) for h in spacing), alpha, beta, gamma, stream)
        else:
            tab = v2.stage_table(terms, spacing, coeffs, where, shape, P)
            args = (P.data_ptr(), aux_ptr, out.data_ptr(), band.data_ptr(), ids.data_ptr(),
                    ids.shape[0], *shape, *tiles, ctypes.addressof(tab))
            if v2.is_advection_only(terms):  # each component's axes: per column, plane or node
                code = (lib.band_stage_prog_f32 if f32 else lib.band_stage_prog_f64)(
                    *args, *terms[0][0].coef_static.axes, stream)
            else:
                code = (lib.band_stage_terms_f32 if f32 else lib.band_stage_terms_f64)(
                    *args, stream)
    v2._raise_on(code, lib, "band_stage kernel")
    bump(band_stage, launches=1, kinds_launches=not v2.is_advection_only(terms),
         program_launches=any(spec.coef_kind == "program" for spec, _ in terms),
         launches_2d=len(shape) == 2)
    return out


band_stage.launches = 0
band_stage.kinds_launches = 0  # of the launches, those of the term-list entry
band_stage.program_launches = 0  # of the launches, those with a program term (K6″)
band_stage.launches_2d = 0  # of the launches, those of a 2D band


def _band_stage_2d(lib, f32, P, aux_ptr, out, ids, band, terms, coeffs, spacing, shape, tiles,
                   where, stream) -> int:
    """Launch K6's 2D entry (``csrc/band_stage.cu``): the advection-only
    streamed stage with its two 2D velocity components, else the term table
    (K6′) or program (K6″) entry with the embedding's table."""
    args = (ids.data_ptr(), ids.shape[0], *shape, *tiles)
    if v2.is_advection_only(terms) and terms[0][0].coef_kind == "stream":
        u = terms[0][1]
        alpha, beta, gamma = (float(c) for c in coeffs)
        return (lib.band_stage_2d_f32 if f32 else lib.band_stage_2d_f64)(
            P.data_ptr(), u[1].data_ptr(), u[2].data_ptr(), aux_ptr, out.data_ptr(),
            band.data_ptr(), *args, *(1.0 / float(h) for h in spacing), alpha, beta, gamma,
            stream)
    spacing3, where3 = embedding_2d(spacing, where)
    tab = v2.stage_table(terms, spacing3, coeffs, where3, (1, *shape), P)
    if v2.is_advection_only(terms):
        fn = lib.band_stage_prog_2d_f32 if f32 else lib.band_stage_prog_2d_f64
    else:
        fn = lib.band_stage_terms_2d_f32 if f32 else lib.band_stage_terms_2d_f64
    return fn(P.data_ptr(), aux_ptr, out.data_ptr(), band.data_ptr(), *args,
              ctypes.addressof(tab), stream)


def band_stage_reference(padded, out_init, compute_mask, term_specs_and_streams, coeffs, t,
                         aux_padded, bcs, spacing, shape, lo, tiles, ids=None,
                         origin=None) -> torch.Tensor:
    """Plain oracle (counterpart of ``lsm_tpu.ops.band_pallas.
    band_stage_reference``): the dense stage (ghosts rebuilt from the
    interior, dense streams or a callable at node coordinates) masked to
    (compute band and active tile); other nodes of an active tile keep
    ``padded``'s value, the rest ``out_init``'s. The active tiles are those
    holding compute-band nodes, or, given the dispatch list ``ids``, the
    dispatched ones (the stepper's, which adds the tiles of the step
    before). Returns a new padded buffer whose shells are ``out_init``'s."""
    shape = tuple(shape)
    dense = v2.stage_reference(padded, term_specs_and_streams, coeffs, t, aux_padded, bcs,
                               spacing, shape, lo, origin)
    cm = compute_mask != 0
    if ids is None:
        ids = active_tile_ids(cm, tiles, math.prod(tile_grid(shape, tiles)))[0]
    act = dispatched_cells(ids, shape, tiles)
    prev = v2.unpack_padded(padded, shape)
    new = torch.where(act & cm, dense,
                      torch.where(act, prev, v2.unpack_padded(out_init, shape)))
    out = out_init.clone()
    v2.unpack_padded(out, shape).copy_(new)
    return out


def band_stage_refresh_plain(P, out_init, ids, band, terms, coeffs, aux, bcs, spacing, shape,
                             tiles, where: Optional[v2.Where] = None) -> torch.Tensor:
    """The plain band composite (counterpart of ``lsm_tpu.ops.band_pallas.
    _band_stage_refresh_jnp``): each tile-packed stream scattered onto the
    grid, :func:`band_stage_reference` on the dispatch list ``ids`` (program
    terms at ``where``), then the full ghost refresh. A new buffer;
    differentiable in ``P``, ``out_init``, ``aux``, the streams, tensor
    ``coeffs`` and a tensor ``where.t``. Its autograd is the backward of
    :func:`band_step_stage`, on both devices."""
    shape = tuple(shape)
    flat, valid = tile_index(ids, shape, tiles)
    idx = flat[valid]

    def dense(packed):
        d = torch.zeros(shape, dtype=P.dtype, device=P.device)
        return d.view(-1).index_put((idx,), packed[valid]).view(shape)

    where = where or v2.Where()
    out = band_stage_reference(P, out_init, band,
                               dense_terms(terms, shape, spacing, where, P, dense), coeffs,
                               where.t, aux, bcs, spacing, shape, where.lo, tiles, ids=ids,
                               origin=where.origin)
    return v2.refresh_ghosts(out, bcs, shape)


class _BandStepStage(torch.autograd.Function):
    """K6 then K7 into a copy of ``out_init``; the backward is autograd of
    :func:`band_stage_refresh_plain` from the saved inputs (the full refresh:
    a phase K7 skipped left shells that already agree with the interior, so
    the composite computes the same output), with no cotangent for the
    dispatch list, the band and the gates, as in JAX's ``_bss_bwd``; the
    stage time ``t`` gets its cotangent through the program terms, as JAX's
    ``dt_``."""

    @staticmethod
    def forward(ctx, P, out_init, aux, ids, band, flags, alpha, beta, gamma, t, statics,
                *streams):
        specs, counts, bcs, spacing, shape, tiles, values, where = statics
        terms = v2._unflatten(specs, counts, streams)
        out = out_init.clone()
        band_stage(P, out, ids, band, terms, values, aux, spacing, shape, tiles, where)
        refresh_band_ghosts_fast(out, bcs, shape, flags)
        ctx.save_for_backward(P, out_init, aux, ids, band, *streams)
        ctx.statics = statics
        ctx.coefs = (alpha, beta, gamma, t)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        P, out_init, aux, ids, band, *streams = ctx.saved_tensors
        specs, counts, bcs, spacing, shape, tiles, _, where = ctx.statics
        need = ctx.needs_input_grad  # P, out_init, aux, ids, band, flags, alpha, beta, gamma,
        with torch.enable_grad():    # t, statics, *streams
            leaf = lambda t, n: t.detach().requires_grad_(n) if t is not None else None
            Pv, Ov, Av = leaf(P, need[0]), leaf(out_init, need[1]), leaf(aux, need[2])
            cv = [c.detach().requires_grad_(need[6 + k]) if isinstance(c, torch.Tensor) else c
                  for k, c in enumerate(ctx.coefs)]
            sv = [leaf(a, n) for a, n in zip(streams, need[11:])]
            at = where.at(cv[3]) if isinstance(cv[3], torch.Tensor) else where
            out = band_stage_refresh_plain(Pv, Ov, ids, band, v2._unflatten(specs, counts, sv),
                                           cv[:3], Av, bcs, spacing, shape, tiles, at)
            inputs = [t for t in (Pv, Ov, Av, *cv, *sv)
                      if isinstance(t, torch.Tensor) and t.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, grad_outputs=g, allow_unused=True)
                         if inputs else ())

        def take(t):
            return next(grads) if isinstance(t, torch.Tensor) and t.requires_grad else None

        dP, dO, dA = take(Pv), take(Ov), take(Av)
        dc = [take(c) for c in cv]
        return (dP, dO, dA, None, None, None, *dc, None, *(take(a) for a in sv))


def band_step_stage(P, out, ids, band, flags, terms, coeffs, aux, bcs, spacing, shape, tiles,
                    coeff_values=None, where: Optional[v2.Where] = None) -> torch.Tensor:
    """One band stage: K6 from ``P`` into ``out``, then K7 on ``out``
    (counterpart of ``lsm_tpu.ops.band_pallas.band_step_stage``).

    When nothing needs a gradient, ``out`` is written in place and returned
    (the stepper's buffer rotation). Otherwise the stage writes a copy of
    ``out`` (JAX's ``out_init`` is functional; autograd cannot save a buffer
    that is written later) through a ``torch.autograd.Function`` whose
    backward is autograd of :func:`band_stage_refresh_plain`: gradients flow
    to ``P``, ``out`` (the nodes the stage leaves), ``aux``, the tile-packed
    streams, tensor ``coeffs`` and, through a program term that depends on
    it, a tensor ``where.t``; the dispatch list, the band and the gates are
    constants. The kernels take the coefficients and the time as host
    numbers (``coeff_values`` and ``where.value``, default ``float`` of
    each); program terms are evaluated at ``where`` as in :func:`band_stage`.
    """
    shape, tiles = tuple(shape), tuple(int(b) for b in tiles)
    terms = v2.as_terms(terms)
    values = tuple(float(c.detach()) if isinstance(c, torch.Tensor) else float(c)
                   for c in (coeffs if coeff_values is None else coeff_values))
    where = where or v2.Where()
    t = where.t if v2.needs_t(terms) else None
    streams = [a for _, arrs in terms for a in arrs]
    tensors = [P, out, aux, *streams, *coeffs, t]
    if not (torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors)):
        band_stage(P, out, ids, band, terms, values, aux, spacing, shape, tiles, where)
        return refresh_band_ghosts_fast(out, bcs, shape, flags)
    statics = (tuple(spec for spec, _ in terms), tuple(len(arrs) for _, arrs in terms), bcs,
               tuple(float(h) for h in spacing), shape, tiles, values, where.at(where.value))
    return _BandStepStage.apply(P, out, aux, ids, band, flags, *coeffs, t, statics, *streams)


# -- K7: the gated shell refresh --------------------------------------------------------


def refresh_band_ghosts_plain(padded: torch.Tensor, bcs, shape, flags) -> torch.Tensor:
    """Plain version of K7: K2's phases (axis 0, 1, then 2) in place, axes 0
    and 1 only where ``flags[0]`` is set, axis 2 only where ``flags[1]`` is
    (2D: axis 0 where ``flags[0]`` is, axis 1 where ``flags[1]`` is).
    Returns ``padded``."""
    f0, f1 = (int(f) for f in flags.tolist())
    gates = (f0, f1) if len(shape) == 2 else (f0, f0, f1)
    for ax, gate in enumerate(gates):
        if gate:
            v2.refresh_axis_plain(padded, bcs, shape, ax)
    return padded


def refresh_band_ghosts_fast(padded: torch.Tensor, bcs, shape, flags: torch.Tensor) -> torch.Tensor:
    """K7: the gated ghost-shell refresh of a padded band buffer, in place.

    Replaces ``lsm_tpu.ops.band_pallas.refresh_band_ghosts_fast``. ``flags``
    is an int32 ``(2,)`` tensor on the buffer's device
    (:func:`refresh_flags_from_activity`); the kernel reads it on the card,
    so gating needs no host synchronisation. CUDA tensors go to
    ``csrc/refresh_ghosts.cu`` (one launch, 3D or 2D: K2's one-launch kernel
    gated by the flags, a small grid whose blocks exit at once when both are
    off; a degree above 7: the same threads on the table route, one launch),
    CPU tensors to :func:`refresh_band_ghosts_plain`. Returns ``padded``.
    """
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"the band ghost refresh takes a 2D or 3D shape, got {shape}")
    v2._check(padded, "padded", v2.padded_shape(shape))
    if (flags.dtype != torch.int32 or tuple(flags.shape) != (2,) or not flags.is_contiguous()
            or flags.device != padded.device):
        raise ValueError("flags must be a contiguous int32 tensor of shape (2,) on the "
                         "buffer's device")
    kinds, degrees, weights = v2._ghost_args(bcs, shape)
    if padded.device.type == "cpu":
        return refresh_band_ghosts_plain(padded, bcs, shape, flags)
    table = v2._ghost_table(bcs, shape, padded.device, padded.dtype)
    if table is not None:
        v2.ghost_table_launch(v2.TABLE_REFRESH, None, padded, bcs, shape, table, flags=flags)
        bump(refresh_band_ghosts_fast, launches=1, launches_2d=len(shape) == 2,
             table_launches=1)
        return padded
    lib = load_library()
    f32 = padded.dtype == torch.float32
    if len(shape) == 2:
        fn = lib.band_refresh_2d_f32 if f32 else lib.band_refresh_2d_f64
    else:
        fn = lib.band_refresh_f32 if f32 else lib.band_refresh_f64
    ctx, stream = v2._on_card(padded)
    with ctx:
        code = fn(padded.data_ptr(), *shape, ctypes.addressof(kinds),
                  ctypes.addressof(degrees), ctypes.addressof(weights), flags.data_ptr(),
                  stream)
    v2._raise_on(code, lib, "refresh_band_ghosts kernel")
    bump(refresh_band_ghosts_fast, launches=1, launches_2d=len(shape) == 2)
    return padded


refresh_band_ghosts_fast.launches = 0
refresh_band_ghosts_fast.launches_2d = 0  # of the launches, those of a 2D band
refresh_band_ghosts_fast.table_launches = 0  # of the launches, those of the table route


# -- K8: the incremental re-tube ---------------------------------------------------------


def retube_full(values: torch.Tensor, band: torch.Tensor, nlayers: int, chalo: int) -> torch.Tensor:
    """The full-grid re-tube: the new combined mask (uint8, 0/1/2) from the
    interior ``values`` and the old combined ``band`` (cut cells among its
    active nodes, corner stamp, dilated by ``nlayers`` and by
    ``nlayers + chalo``)."""
    mask = band_mask_from_values(values, nlayers, band == ACTIVE)
    return box_dilate(mask, chalo).to(torch.uint8) + mask.to(torch.uint8)


def _check_count(count: torch.Tensor, like: torch.Tensor):
    if not isinstance(count, torch.Tensor) or count.dtype != torch.int32 or count.ndim != 0:
        raise ValueError("count must be a 0-d int32 tensor (compact_ids's count)")
    if count.device != like.device:
        raise ValueError(f"count lies on {count.device}, the state on {like.device}")


def band_retube_plain(P, band, cand, nlayers, chalo, shape, tiles,
                      count: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the full re-tube, copied into ``band`` (in place)
    on the candidate tiles only (the first ``count`` slots of ``cand``).
    Returns ``int32[len(cand)]``, 1 where the new candidate tile holds a
    band node."""
    new = retube_full(v2.unpack_padded(P, shape), band, nlayers, chalo)
    flat, valid = tile_index(cand, shape, tiles)
    used = torch.arange(cand.shape[0], device=cand.device) < count
    valid = valid & used.reshape([-1] + [1] * len(shape))
    packed = new.view(-1)[flat]
    band.view(-1)[flat[valid]] = packed[valid]
    return ((packed != 0) & valid).flatten(1).any(dim=1).to(torch.int32)


def band_retube_incremental(P: torch.Tensor, band: torch.Tensor, cand: torch.Tensor, nlayers: int,
                            chalo: int, shape, tiles, count: torch.Tensor) -> torch.Tensor:
    """K8: re-tube the candidate tiles of the combined mask ``band`` in place.

    Replaces ``lsm_tpu.ops.band_pallas.band_retube_incremental``. ``P`` the
    padded phi, ``band`` the uint8 combined mask, ``cand`` an int32 list of
    tile ids (-1 for empty slots), ``count`` (a 0-d int32 tensor on the
    device, :func:`compact_ids`'s count) how many leading slots of ``cand``
    to re-tube. Exact against the full re-tube when every
    tile that can change is a candidate (the active tiles and their
    neighbours, with tiles at least ``1 + nlayers + chalo`` deep). Returns
    ``int32[len(cand)]`` activity flags (0 past ``count``). CUDA tensors go
    to ``csrc/band_retube.cu`` (two launches over the candidates only, a
    2D band to the 2D entry; no scratch: each new value waits in its mask
    byte's high bits until the second launch), CPU tensors to
    :func:`band_retube_plain`. The band carries no gradient.
    """
    shape, tiles = tuple(shape), tuple(int(b) for b in tiles)
    _check_tiles(shape, tiles)
    v2._check(P, "P", v2.padded_shape(shape))
    _check_band(band, shape, P)
    _check_ids(cand, "cand", P)
    _check_count(count, P)
    if P.device.type == "cpu":
        return band_retube_plain(P, band, cand, nlayers, chalo, shape, tiles, count)
    lib = load_library()
    f32 = P.dtype == torch.float32
    if len(shape) == 2:
        fn = lib.band_retube_2d_f32 if f32 else lib.band_retube_2d_f64
        smem = lib.band_retube_smem_2d(*tiles, nlayers, chalo)
    else:
        fn = lib.band_retube_f32 if f32 else lib.band_retube_f64
        smem = lib.band_retube_smem(*tiles, nlayers, chalo)
    if not 0 <= smem <= 227 * 1024:
        raise ValueError(f"tiles {tiles} with nlayers={nlayers}, chalo={chalo}: the re-tube "
                         "takes radii nlayers + chalo <= 31 and bit planes within a block's "
                         "232448 bytes of shared memory")
    ncand = cand.shape[0]
    flags = torch.zeros(ncand, dtype=torch.int32, device=P.device)
    with torch.cuda.device(P.device):
        code = fn(P.data_ptr(), band.data_ptr(), cand.data_ptr(), count.data_ptr(),
                  flags.data_ptr(), ncand, *shape, *tiles, int(nlayers), int(chalo),
                  torch.cuda.current_stream().cuda_stream)
    v2._raise_on(code, lib, "band_retube kernel")
    bump(band_retube_incremental, launches=1, launches_2d=len(shape) == 2)
    return flags


band_retube_incremental.launches = 0
band_retube_incremental.launches_2d = 0  # of the launches, those of a 2D band
