"""Band-proportional fused evolution (port of
:mod:`lsm_tpu.integrators.band_fused`).

For a 3D or 2D :class:`~lsm_tpu_torch.core.narrowband.NarrowBandField` the
stepper keeps the level set in padded buffers and the band in one uint8
combined mask (0 outside, 1 compute band only, 2 active band). Each RK stage is one K6
launch over a dispatch list of tiles (:func:`~lsm_tpu_torch.ops.band.
band_stage`) and one gated K7 shell refresh; a re-tube step ends with K8 on
the candidate tiles (the active tiles and their neighbours), after which
the tile activity, the dispatch list and the K7 gates are rebuilt on the
device in plain torch. The terms are any list the dense stepper takes
(advection, normal motion, curvature, eikonal reinitialization) without
``update_func`` (which takes the general path, as JAX's band stepper
refuses it): a callable traced into a program is evaluated per node inside
K6 (K6″), with nothing kept per slot; another callable is evaluated at the
dispatched tiles' nodes only and a streamed coefficient gathered onto them
once per re-tube, so a step has no pass over the whole grid.

A 2D band keeps its own ``(n0+6, n1+6)`` layout, ``(B0, B1)`` tiles and
the 2D entries of K6, K7 and K8 (:mod:`lsm_tpu_torch.ops.band`), while its
terms are those of the ``(1, n0, n1)`` embedding that JAX's band stepper
runs (:func:`~lsm_tpu_torch.integrators.fused.term_entries`), so the stage
computes JAX's function. JAX re-tubes a 2D band in full every step (its
embedding's one-node tiles on the dummy axis are below K8's reach); here
the 2D tiles meet the reach, and K8 re-tubes the candidate tiles only.

Buffer rotation. Off-band cells are frozen, so a stage writes its tiles
into the previous buffer of the rotation and leaves the rest alone:

  FE :  A -> B                                  next state (B, A)
  RK2:  A -> B;  (B, aux A) -> C                next state (C, A, B)
  RK3:  A -> B;  (B, aux A) -> C; (C, aux A) -> B   next state (B, A, C)

That is right only if every buffer agrees on every tile the stages skip.
A node updated in one step lies in a tile that was active then; if the band
leaves that tile at the re-tube, the spare buffers would keep its older
value. The port therefore dispatches the active tiles of this step and of
the step before (``disp = act | previous act``): a tile that has just left
the band is visited once more, where every node is off the compute band, so
each buffer the step writes takes the current value there.

Gradients. When the state or a coefficient requires a gradient, every stage
is :func:`~lsm_tpu_torch.ops.band.band_step_stage`: K6 and K7 into a copy of
the rotation's target (autograd cannot save a buffer that a later stage
writes), backward by autograd of the plain band composite. The tile-packed
streams are gathered from the dense coefficients by tracked indexing, again
at each re-tube, so a coefficient's gradient reaches its dense tensor. The
re-tube (K8), the activity, the dispatch list and the K7 gates carry no
gradient, as in JAX; under a gradient K8 re-tubes a copy of the band, so a
checkpointed step recomputes the same masks.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from ..core import bc as _bc
from ..core.narrowband import NarrowBandField, box_dilate
from ..ops import band as bd
from ..ops import weno_v2 as v2
from ..terms.terms import kind_cfl
from .explicit import RK3
from .fused import _STAGES, _field_reason, _terms_reason, term_entries

__all__ = ["BandState", "FusedBandStepper", "supports_band_fused", "unsupported_reason",
           "default_tiles"]

#: the default dispatch capacity: the active tiles times SLACK, plus 32
SLACK = 1.5
#: ``regrow`` multiplies the capacity by this
REGROW = 2

class BandState(NamedTuple):
    """The band stepper's state (all on the field's device)."""

    bufs: Tuple[torch.Tensor, ...]  # padded phi: (current, spare[, spare])
    band: torch.Tensor    # uint8 interior-shaped combined mask, 0/1/2
    act: torch.Tensor     # bool tile grid: tiles holding compute-band nodes
    ids: torch.Tensor     # int32 (capacity,): dispatch list of act | previous act
    count: torch.Tensor   # int32 0-d: tiles on the dispatch list (> capacity: overflow)
    flags: torch.Tensor   # int32 (2,): K7's gates for the dispatched tiles
    amask: torch.Tensor   # bool (capacity, *tiles): active-band nodes per slot
    coefs: Tuple[Tuple[torch.Tensor, ...], ...]  # per term: its tile-packed streams
    xs: Optional[Tuple[torch.Tensor, ...]]  # the slots' node coordinates, for the
    # callables on the stream route (a program term needs none)


def unsupported_reason(terms, nb, integrator) -> Optional[str]:
    """Why ``(terms, nb, integrator)`` cannot take the band stepper; ``None``
    when it can."""
    if not isinstance(nb, NarrowBandField):
        return "the band stepper takes a NarrowBandField"
    terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
    if any(getattr(t, "update_func", None) is not None for t in terms):
        return ("a term with update_func on a NarrowBandField takes the general path (JAX's "
                "band stepper does not take it either)")
    return _field_reason(nb, integrator) or _terms_reason(terms, nb)


def supports_band_fused(terms, nb, integrator=None) -> bool:
    """Whether ``(terms, nb)`` qualifies for :class:`FusedBandStepper`."""
    return unsupported_reason(terms, nb, integrator or RK3()) is None


#: the 2D default tile: of the tiles ``tools/band_tile_sweep.py --2d`` tried
#: on the D2b band (the Zalesak disk at 4096^2), the one with the least
#: device time per RK3 step, beside 32x32 (the step's host time does not
#: depend on the tiles; PERF.md)
TILES_2D = (16, 64)


def default_tiles(nlayers: int = 3, ndim: int = 3) -> Tuple[int, ...]:
    """3D: cubes of 16 nodes; 2D: :data:`TILES_2D`; each axis deepened where
    the incremental re-tube needs it (at least ``1 + nlayers +
    COMPUTE_HALO`` nodes). Of the tiles ``tools/band_tile_sweep.py`` tried
    on the 512^3 sphere band, 16^3 gave the fastest step (PERF.md)."""
    reach = 1 + nlayers + NarrowBandField.COMPUTE_HALO
    return tuple(max(b, reach) for b in ((16,) * 3 if ndim == 3 else TILES_2D))


def _face_layers(bcs, shape, tiles):
    """Per axis, how many tile layers at each face hold the nodes its ghosts
    are built from: symmetry reads 3 nodes in, extrapolation of degree P
    reads P + 1."""
    out = []
    for ax, (n, b) in enumerate(zip(shape, tiles)):
        G = -(-n // b)
        pair = []
        for side, bcd in enumerate(bcs[ax]):
            depth = bcd.degree + 1 if isinstance(bcd, _bc.Extrapolation) else v2.GHOST + 1
            depth = min(depth, n)
            pair.append(-(-depth // b) if side == 0 else G - (n - depth) // b)
        out.append(tuple(pair))
    return tuple(out)


class FusedBandStepper:
    """Active-tile fused stepping for a 3D or 2D :class:`NarrowBandField`.

    Usage::

        stepper = FusedBandStepper(terms, nb, integrator)
        state = stepper.pack(nb)
        for _ in range(nsteps):
            state = stepper.step(state, t, dt)
            t += dt
        nb_out = stepper.unpack(state)

    ``tiles`` (default :func:`default_tiles`) cut the grid; on CUDA every
    tile must be at least ``1 + nlayers + COMPUTE_HALO`` nodes deep, which
    the incremental re-tube (K8) needs; on the CPU shallower tiles take the
    full re-tube. ``capacity`` bounds the dispatch list (default: the active
    tiles times ``SLACK``, plus 32). ``state.count > capacity`` means the
    list overflowed: :meth:`cfl` returns the count with the CFL bound, and
    ``integrate`` calls :meth:`regrow` before such a band is stepped.
    ``retube_every`` re-tubes every k-th step, within the CFL safety range.
    """

    def __init__(self, terms, nb: NarrowBandField, integrator,
                 tiles: Optional[Tuple[int, ...]] = None,
                 capacity: Optional[int] = None, retube_every: int = 1):
        terms = tuple(terms) if isinstance(terms, (tuple, list)) else (terms,)
        reason = unsupported_reason(terms, nb, integrator)
        if reason is not None:
            raise NotImplementedError(reason)
        # between re-tubes the interface moves at most `cfl` cells per step
        # and the compute band reaches COMPUTE_HALO cells past the active
        # band, so skipping the re-tube for up to margin/cfl steps never
        # lets the interface outrun the stale band
        margin = min(nb.nlayers, NarrowBandField.COMPUTE_HALO)
        max_skip = max(1, int(margin / integrator.cfl))
        if not 1 <= retube_every <= max_skip:
            raise ValueError(
                f"retube_every={retube_every} outside the safe range [1, {max_skip}] for "
                f"cfl={integrator.cfl} (interface may outrun the stale compute band)")
        self.retube_every = int(retube_every)
        self.terms = terms
        self.integrator = integrator
        self.grid, self.bcs, self.nlayers = nb.grid, nb.bcs, nb.nlayers
        self.shape = tuple(nb.shape)
        self.spacing = tuple(float(h) for h in nb.spacing)
        self.lo = tuple(float(x) for x in nb.grid.lo)
        self.dtype, self.device = nb.dtype, nb.device
        self.stages = _STAGES[type(integrator)]
        self.is2d = nb.ndim == 2
        self.tiles = tuple(int(b) for b in (tiles or default_tiles(nb.nlayers, nb.ndim)))
        if len(self.tiles) != nb.ndim or min(self.tiles) < 1:
            raise ValueError(f"tiles must be {nb.ndim} positive sizes, got {tiles}")
        #: the re-tube runs K8 on the candidate tiles when a change can reach
        #: at most one tile away: every tile at least 1 + nlayers + halo deep
        reach = 1 + self.nlayers + NarrowBandField.COMPUTE_HALO
        self.incremental = min(self.tiles) >= reach
        if not self.incremental and self.device.type == "cuda":
            raise ValueError(
                f"tiles {self.tiles} are shallower than the incremental re-tube's reach "
                f"1 + nlayers + COMPUTE_HALO = {reach} on some axis; on CUDA every tile "
                f"must be at least {reach} nodes deep")
        self.total = math.prod(bd.tile_grid(self.shape, self.tiles))
        if capacity is None:
            n_active = int(bd.tile_activity(nb.compute_mask, self.tiles).sum())
            capacity = min(self.total, max(64, int(n_active * SLACK) + 32))
        self.capacity = int(capacity)
        self._layers = _face_layers(self.bcs, self.shape, self.tiles)
        #: per term (TermSpec, dense streams); a callable keeps its function;
        #: a 2D band's are those of the (1, n0, n1) embedding
        self.entries = term_entries(terms, nb)
        self._analytic = any(spec.coef_kind == "analytic" for spec, _ in self.entries)
        self._cache = None

    # -- layout -----------------------------------------------------------------------

    def _dispatch(self, band, act, disp, bufs) -> BandState:
        """The state for dispatch activity ``disp``: the list, its count,
        K7's gates, the per-slot active mask, each term's tile-packed streams
        and, for callable coefficients, the slots' coordinates."""
        ids, count = bd.compact_ids(disp, self.capacity)
        flags = bd.refresh_flags_from_activity(disp, self._layers)
        flat, valid = bd.tile_index(ids, self.shape, self.tiles)
        amask = (band.view(-1)[flat] == bd.ACTIVE) & valid
        coefs = tuple(tuple(a.reshape(-1)[flat] for a in arrs) for _, arrs in self.entries)
        xs = self._slot_coords(ids) if self._analytic else None
        return BandState(tuple(bufs), band, act, ids, count, flags, amask, coefs, xs)

    def _slot_coords(self, ids):
        """The dispatched nodes' coordinates, as the entries' callables take
        them (a 2D band's: the embedding's, coordinate 0 zero)."""
        xs = bd.tile_coords(ids, self.shape, self.tiles, self.spacing, self.lo, self.dtype)
        if self.is2d:
            xs = (torch.zeros((), dtype=self.dtype, device=self.device), *xs)
        return xs

    def pack(self, nb: NarrowBandField) -> BandState:
        Q = v2.pack_padded(nb.values.to(device=self.device, dtype=self.dtype), self.bcs)
        bufs = (Q, Q.clone()) if len(self.stages) == 1 else (Q, Q.clone(), Q.clone())
        band = nb.compute_mask.to(torch.uint8) + nb.mask.to(torch.uint8)
        act = bd.tile_activity(band, self.tiles)
        return self._dispatch(band.contiguous(), act, act, bufs)

    def _field(self, state: BandState) -> NarrowBandField:
        return NarrowBandField(v2.unpack_padded(state.bufs[0], self.shape).contiguous(),
                               self.grid, self.bcs, state.band == bd.ACTIVE, self.nlayers,
                               _normalized=True, _cmask=state.band != 0)

    def unpack(self, state: BandState, check: bool = True) -> NarrowBandField:
        """The band field of ``state``. With ``check`` (one host read) warns
        when the dispatch list has overflowed: a step taken with it then
        skipped tiles."""
        if check and self.overflowed(state):
            warnings.warn(
                f"band dispatch list overflowed (count={int(state.count)} > "
                f"capacity={self.capacity}): some active tiles were never stepped; "
                "use regrow() and re-run", RuntimeWarning, stacklevel=2)
        return self._field(state)

    def overflowed(self, state: BandState) -> bool:
        return int(state.count) > self.capacity

    # -- stepping ---------------------------------------------------------------------

    def stage_terms(self, state: BandState, t):
        """K6's term list at time ``t``, every stream tile-packed (a callable
        is evaluated at the dispatched nodes; the last evaluation is kept
        unless it carries a gradient, so the CFL bound at ``t`` and the
        step's first stage share one)."""
        terms = tuple((spec, arrs) for (spec, _), arrs in zip(self.entries, state.coefs))
        if not self._analytic:
            return terms
        c = self._cache
        if c is not None and c[0] == float(t) and c[1] is state.xs:
            return c[2]
        terms = v2.resolve_terms(terms, state.xs, t, (self.capacity, *self.tiles), self.dtype,
                                 self.device)
        if not any(a.requires_grad for _, arrs in terms for a in arrs):
            self._cache = (float(t), state.xs, terms)
        return terms

    def stage(self, src, dst, state, coeffs, t_stage, aux, coeff_values=None, t_value=None):
        """K6 from ``src`` into ``dst``, then K7 on ``dst``; in place, or
        into a copy of ``dst`` when a gradient is needed
        (:func:`~lsm_tpu_torch.ops.band.band_step_stage`). Program terms see
        the stage time ``t_stage`` (``t_value`` its host number)."""
        return bd.band_step_stage(src, dst, state.ids, state.band, state.flags,
                                  self.stage_terms(state, t_stage), coeffs, aux, self.bcs,
                                  self.spacing, self.shape, self.tiles, coeff_values,
                                  v2.Where(self.lo, None, t_stage, t_value))

    def step(self, state: BandState, t, dt, retube: bool = True, dt_value=None) -> BandState:
        """One accepted step; ``retube=False`` keeps the band (valid only
        within ``retube_every``). ``t`` and ``dt`` may be tensors (the stage
        coefficients and a callable coefficient then carry their
        gradients); the kernels take ``dt_value`` (default ``float(dt)``)."""
        dtv = float(dt) if dt_value is None else float(dt_value)
        tv = ((float(t.detach()) if isinstance(t, torch.Tensor) else float(t))
              if v2.needs_t(self.entries) else 0.0)
        bufs = state.bufs
        A = bufs[0]
        # the rotation's targets; a differentiated stage returns a new tensor
        # in place of its target, which later stages then write
        targets = list(bufs[1:])
        src = A
        for s, (alpha, beta, g, off) in enumerate(self.stages):
            k = s % 2
            targets[k] = self.stage(src, targets[k], state, (alpha, beta, g * dt),
                                    t + off * dt, None if s == 0 else A,
                                    coeff_values=(alpha, beta, g * dtv), t_value=tv + off * dtv)
            src = targets[k]
        last = (len(self.stages) - 1) % 2
        new = (targets[last], A) + ((targets[1 - last],) if len(targets) == 2 else ())
        if not retube:
            return state._replace(bufs=new)
        return self._retube(state, new)

    def _retube(self, state: BandState, bufs) -> BandState:
        """Re-tube after a step (K8 on the candidate tiles, or on the CPU
        the full re-tube when the tiles are too shallow for it), then
        rebuild the dispatch for the new activity and the one before."""
        cur = bufs[0]
        band = state.band
        if torch.is_grad_enabled() and cur.requires_grad:
            band = band.clone()  # a stage of this step saved it for its backward
        if self.incremental:
            # the candidates (the active tiles and their neighbours) in a list
            # with a slot for every tile of the grid, so it cannot overflow;
            # K8 runs over the first `count` slots only and needs no scratch
            cids, count = bd.compact_ids(box_dilate(state.act, 1), self.total)
            act = bd.scatter_activity(state.act, cids,
                                      self.retube_tiles(cur, band, cids, count))
        else:
            band = bd.retube_full(v2.unpack_padded(cur, self.shape), band, self.nlayers,
                                  NarrowBandField.COMPUTE_HALO)
            act = bd.tile_activity(band, self.tiles)
        return self._dispatch(band, act, act | state.act, bufs)

    def retube_tiles(self, cur, band, cids, count):
        """K8 on the first ``count`` candidate tiles of ``cids``: ``band``
        re-tubed in place, one activity flag per slot."""
        return bd.band_retube_incremental(cur, band, cids, self.nlayers,
                                          NarrowBandField.COMPUTE_HALO, self.shape, self.tiles,
                                          count)

    # -- adaptive CFL and overflow ------------------------------------------------------

    def cfl(self, state: BandState, t):
        """``(largest stable dt, tiles on the dispatch list)`` as device
        tensors, for one read-back per step. The bound is the minimum over
        the terms, each reduced over the active band only from its
        coefficients at the dispatched nodes (every active node lies in a
        dispatched tile while the list has not overflowed); a constant
        coefficient's bound is a host number."""
        out = None
        for spec, arrs in self.stage_terms(state, t):
            if spec.coef_kind == "const":
                coef = (spec.coef_static,)
            elif spec.coef_kind == "program":
                coef = self._slot_values(spec, state, t)
            else:
                coef = arrs
            if self.is2d and spec.kind == "advection":
                coef = coef[1:]  # the embedding's zero component
            dt = kind_cfl(spec.kind, coef, state.amask, self.spacing, state.bufs[0])
            out = dt if out is None else torch.minimum(out, dt)
        return out, state.count

    def _slot_values(self, spec, state: BandState, t):
        """A program term's coefficient at the dispatched nodes, tile-packed
        (for the CFL bound only: K6″ evaluates it in-kernel)."""
        xs = self._slot_coords(state.ids)
        tt = torch.as_tensor(t, dtype=self.dtype, device=self.device)
        return tuple(torch.broadcast_to(torch.as_tensor(c, dtype=self.dtype, device=self.device),
                                        (self.capacity, *self.tiles))
                     for c in spec.coef_static.evaluate(xs, tt))

    def regrow(self, state: BandState):
        """Recover from a dispatch-list overflow: a stepper with ``REGROW``
        times the capacity and the current state packed into it. Returns
        ``(stepper, state)``. ``integrate`` calls it before an overflowed band
        is stepped, so no update is lost."""
        nb = self._field(state)
        stepper = FusedBandStepper(
            self.terms, nb, self.integrator, tiles=self.tiles,
            capacity=min(self.total, max(self.capacity * REGROW, 64)),
            retube_every=self.retube_every)
        return stepper, stepper.pack(nb)
