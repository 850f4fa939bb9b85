"""High-order signed distance by Newton closest points (port of
:mod:`lsm_tpu.interp.sdf`).

Sample the interface by Newton-projecting seeds onto ``{phi = 0}`` of the
Bernstein interpolant, then answer ``sdf(x)`` by nearest-sample seeding and a
constrained (KKT) Newton solve of ``min |x - p|^2 s.t. phi(p) = 0``. Every
stage is a batched tensor computation on the field's device: the seeds of
the non-empty cells project together, the nearest-sample search is a
jump-flood seed grid (``O(grid log grid)``, independent of the sample count),
and the KKT iterations run in lockstep over a chunk of queries with converged
lanes frozen by ``where``. Plain torch (JAX's is XLA; no TPU kernel runs it).
"""

from __future__ import annotations

import itertools
import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..core.field import MeshField
from .interpolation import InterpolatedField

__all__ = ["NewtonSDF", "reinitialize_newton", "hausdorff_distance"]

_PROJECT_CHUNK = 1 << 20  # seeds a projection batch (pointwise: no effect on results)


def _first_set(flat: torch.Tensor, capacity: int):
    """The flat indices of the first ``capacity`` set entries of ``flat`` in
    order, padded with 0, and the number set (a 0-d tensor): a cumsum and a
    scatter on the device, no host read."""
    pos = torch.cumsum(flat.to(torch.int64), 0)
    target = torch.where(flat & (pos <= capacity), pos - 1, capacity)
    idx = torch.zeros(capacity + 1, dtype=torch.int64, device=flat.device)
    idx.scatter_(0, target, torch.arange(flat.numel(), device=flat.device))
    return idx[:capacity], pos[-1]


def _project_to_interface(cf: InterpolatedField, pts, maxiters: int, ftol, domain_lo,
                          domain_hi):
    """Newton projection ``p <- p - phi grad / |grad|^2`` onto the zero set
    (over the whole field, so iterates may cross cells), each step capped at a
    cell. Returns ``(points, converged)``."""
    h = torch.as_tensor(cf.grid.spacing, dtype=pts.dtype, device=pts.device)
    outs, oks = [], []
    for p in pts.split(_PROJECT_CHUNK):
        for _ in range(maxiters):
            v, g = cf.value_and_gradient(p)
            gg = torch.sum(g * g, -1, keepdim=True)
            step = v[..., None] * g / torch.clamp(gg, min=1e-300)
            step = torch.minimum(torch.maximum(step, -h), h)
            p = torch.minimum(torch.maximum(p - step, domain_lo), domain_hi)
        outs.append(p)
        oks.append(torch.abs(cf(p)) < ftol)
    if not outs:
        return pts, torch.zeros(0, dtype=torch.bool, device=pts.device)
    return torch.cat(outs), torch.cat(oks)


def _kkt_closest_point(cf: InterpolatedField, x, seed, maxiters: int):
    """Damped Newton on the KKT system of ``min 1/2 |x - p|^2 s.t. phi(p) =
    0``: residual ``[(p - x) + lam grad; phi]``, Jacobian ``[[I + lam H,
    grad], [grad^T, 0]]`` with Tikhonov regularization and the position step
    capped at a cell. Returns ``(p, converged)``. The loop stops once every
    lane has converged (a frozen lane no longer changes): one host read an
    iteration."""
    ndim, dtype = x.shape[-1], x.dtype
    cap = max(cf.grid.spacing)
    tol = 10 * np.sqrt(np.finfo(np.float64).eps)
    eye = torch.eye(ndim, dtype=dtype, device=x.device)

    v, g = cf.value_and_gradient(seed)
    lam = torch.sum((x - seed) * g, -1) / torch.clamp(torch.sum(g * g, -1), min=1e-300)
    p = seed
    done = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    for _ in range(maxiters):
        v, g, H = cf.value_gradient_hessian(p)
        res_p = (p - x) + lam[..., None] * g
        J11 = eye + lam[..., None, None] * H + 1e-12 * eye
        top = torch.cat([J11, g[..., :, None]], -1)
        bot = torch.cat([g[..., None, :], torch.zeros(g.shape[:-1] + (1, 1), dtype=dtype,
                                                      device=x.device)], -1)
        J = torch.cat([top, bot], -2)
        F = torch.cat([res_p, v[..., None]], -1)
        delta = torch.linalg.solve_ex(J, F[..., None])[0][..., 0]
        dp = delta[..., :ndim]
        norm = torch.linalg.vector_norm(dp, dim=-1, keepdim=True)
        scale = torch.clamp(cap / torch.clamp(norm, min=1e-300), max=1.0)
        p_new = p - dp * scale
        lam_new = lam - delta[..., ndim]
        resid = torch.maximum(torch.linalg.vector_norm(res_p, dim=-1), torch.abs(v))
        stop = done | (resid < tol)
        p = torch.where(stop[..., None], p, p_new)
        lam = torch.where(stop, lam, lam_new)
        done = stop
        if bool(done.all()):
            break
    return p, done


class NewtonSDF:
    """Callable signed-distance oracle built from a level-set field.

    ``NewtonSDF(phi, order=3, upsample=2, maxiters=20)``; query with
    ``sdf(x)`` for a point or an ``(..., N)`` batch. ``sample_points()``
    returns the interface samples and their validity mask. The default build
    reads the non-empty cells back to the host once (an exact-size seed set);
    ``max_cut_cells`` builds on the device with that many cells' seeds, and
    ``overflowed`` (a 0-d bool tensor) says whether more cells were cut (their
    seeds are then missing).
    """

    def __init__(self, phi: MeshField, order: int = 3, upsample: int = 2, maxiters: int = 20,
                 ftol: Optional[float] = None, max_cut_cells: Optional[int] = None):
        cf = InterpolatedField(phi, order)
        grid = phi.grid
        ndim, dtype, dev = grid.ndim, phi.dtype, cf.device
        if ftol is None:
            ftol = 10 * math.sqrt(np.finfo(np.float64).eps)
        # seeds: an (upsample+1)^N lattice in every non-empty cell only
        live = None
        self.overflowed = None
        empty = cf.proven_empty(surface=True)
        if max_cut_cells is None:
            cell_idx = torch.nonzero(~empty)  # (ncut, N), row-major order
        else:
            flat = ~empty.reshape(-1)
            idx, n_cut = _first_set(flat, int(max_cut_cells))  # sentinel rows alias cell 0
            self.overflowed = n_cut > max_cut_cells
            live = flat[idx]
            cell_idx = torch.stack(torch.unravel_index(idx, grid.cells_shape), -1)
        u = upsample + 1
        offs_1d = (np.arange(u) + 0.5) / u
        mesh = np.meshgrid(*([offs_1d] * ndim), indexing="ij")
        offs = torch.as_tensor(np.stack([m.ravel() for m in mesh], -1), dtype=dtype, device=dev)
        lo = torch.as_tensor(grid.lo, dtype=dtype, device=dev)
        hi = torch.as_tensor(grid.hi, dtype=dtype, device=dev)
        h = torch.as_tensor(grid.spacing, dtype=dtype, device=dev)
        seeds = (lo + cell_idx[:, None, :].to(dtype) * h + offs[None] * h).reshape(-1, ndim)
        pts, converged = _project_to_interface(cf, seeds, maxiters, ftol, lo, hi)
        if live is not None:
            converged = converged & torch.repeat_interleave(live, offs.shape[0])
        self.cf, self.samples, self.valid = cf, pts, converged
        self.order, self.maxiters = order, maxiters
        self._seed_cache = None

    def sample_points(self):
        """Interface samples ``(points, validity mask)``."""
        return self.samples, self.valid

    # -- nearest-sample seeding: a jump-flood seed grid ---------------------------------
    #
    # Samples are binned to their nearest grid node (the closest sample wins:
    # a stable sort by descending distance, then a scatter-max of the sort
    # position), then log2(n) flood passes propagate each node's nearest
    # sample position across the grid (1+JFA: an extra unit pass; 3^N - 1
    # shifted gathers a pass). The seed it returns is within one flood
    # approximation of the nearest sample; the KKT solve needs only a seed in
    # the right basin, and retries from the next candidates.

    def _seed_grid(self):
        if self._seed_cache is None:
            self._seed_cache = self._compute_seed_grid(self.samples, self.valid)
        return self._seed_cache

    def _compute_seed_grid(self, S, V):
        grid = self.cf.grid
        ndim, dtype, dev = grid.ndim, S.dtype, S.device
        shape = tuple(grid.shape)
        lo = torch.as_tensor(grid.lo, dtype=dtype, device=dev)
        h = torch.as_tensor(grid.spacing, dtype=dtype, device=dev)
        top = torch.as_tensor(shape, dtype=torch.int64, device=dev) - 1
        idx = torch.minimum(torch.clamp(torch.round((S - lo) / h).long(), min=0), top)
        d2 = torch.sum((S - (lo + idx.to(dtype) * h)) ** 2, -1)
        d2 = torch.where(V, d2, torch.full_like(d2, math.inf))
        order = torch.argsort(-d2, stable=True)  # worst first; invalid (inf) first of all
        strides = [math.prod(shape[d + 1:]) for d in range(ndim)]
        lin = sum(idx[order, d] * strides[d] for d in range(ndim))
        ok = V[order]
        lin = torch.where(ok, lin, 0)
        ranks = torch.arange(S.shape[0], dtype=torch.int64, device=dev)
        pos_rank = torch.full((math.prod(shape),), -1, dtype=torch.int64, device=dev)
        pos_rank.scatter_reduce_(0, lin, torch.where(ok, ranks, -1), "amax")
        pos_rank = pos_rank.reshape(shape)
        have = pos_rank >= 0
        pos = torch.where(have[..., None], S[order][torch.clamp(pos_rank, min=0)],
                          torch.zeros((), dtype=dtype, device=dev))
        coords = torch.stack(grid.dense_coords(dtype=dtype, device=dev), -1)
        offsets = [o for o in itertools.product((-1, 0, 1), repeat=ndim) if any(o)]
        inf = torch.full((), math.inf, dtype=dtype, device=dev)
        aranges = [torch.arange(n, device=dev) for n in shape]

        def shift_clamp(a, off, step):
            for d, o in enumerate(off):
                if o:
                    a = a.index_select(d, torch.clamp(aranges[d] + o * step, 0, shape[d] - 1))
            return a

        steps, stp = [1], 1
        while stp < max(shape):
            stp *= 2
        while stp >= 1:
            steps.append(stp)
            stp //= 2
        for step in sorted(steps, reverse=True):
            best = torch.where(have, torch.sum((coords - pos) ** 2, -1), inf)
            for off in offsets:
                cand, cand_have = shift_clamp(pos, off, step), shift_clamp(have, off, step)
                cd2 = torch.where(cand_have, torch.sum((coords - cand) ** 2, -1), inf)
                better = cd2 < best
                pos = torch.where(better[..., None], cand, pos)
                have = have | (better & cand_have)
                best = torch.where(better, cd2, best)
        return pos, have

    def _nearest_seed_positions(self, x: torch.Tensor, k: int = 3) -> torch.Tensor:
        """``(..., k, ndim)`` candidate seeds per query by increasing distance:
        the flood's nearest samples of the query's node and its face
        neighbours."""
        grid = self.cf.grid
        ndim, dtype, dev = grid.ndim, x.dtype, x.device
        lo = torch.as_tensor(grid.lo, dtype=dtype, device=dev)
        h = torch.as_tensor(grid.spacing, dtype=dtype, device=dev)
        top = torch.as_tensor(grid.shape, dtype=torch.int64, device=dev) - 1
        pos, _ = self._seed_grid()
        idx = torch.minimum(torch.clamp(torch.round((x - lo) / h).long(), min=0), top)
        offsets = [(0,) * ndim] + [tuple(s if dd == d else 0 for dd in range(ndim))
                                   for d in range(ndim) for s in (-1, 1)]
        cands = []
        for off in offsets:
            ii = torch.minimum(torch.clamp(idx + torch.as_tensor(off, device=dev), min=0), top)
            cands.append(pos[tuple(ii[..., d] for d in range(ndim))])
        cand = torch.stack(cands, -2)  # (..., 2N+1, ndim)
        d2 = torch.sum((x[..., None, :] - cand) ** 2, -1)
        order = torch.argsort(d2, dim=-1, stable=True)[..., :k]
        return torch.take_along_dim(cand, order[..., None], -2)

    def _closest_point_chunk(self, pts):
        """Closest points of a flat ``(m, N)`` chunk of queries."""
        cands = self._nearest_seed_positions(pts, k=3)
        seed0 = cands[..., 0, :]
        cp, ok = _kkt_closest_point(self.cf, pts, seed0, self.maxiters)
        # retries from the next-nearest seeds, run on the lanes that did not
        # converge only (JAX runs every lane and keeps these lanes' results)
        for q in range(1, cands.shape[-2]):
            bad = torch.nonzero(~ok)[:, 0]
            if bad.numel() == 0:
                break
            cp_q, ok_q = _kkt_closest_point(self.cf, pts[bad], cands[bad, q],
                                            2 * self.maxiters)
            cp[bad] = torch.where(ok_q[:, None], cp_q, cp[bad])
            ok[bad] = ok_q
        # a lane that did not converge keeps its iterate when it landed on the
        # interface (tangential optimality unfinished); else its seed
        on_surface = torch.abs(self.cf(cp)) < 0.05 * float(min(self.cf.grid.spacing))
        return torch.where((ok | on_surface)[..., None], cp, seed0), ok

    def closest_point(self, x, chunk: Optional[int] = None):
        """Closest interface point(s) of ``x`` by nearest-sample seeding and
        KKT Newton; ``(cp, converged)``. Large batches run ``chunk`` points at
        a time (the results do not depend on it; default 2^14 on the CPU, as
        JAX's, and 2^20 on the card, where a chunk's hundreds of small
        launches would otherwise bind)."""
        x = torch.as_tensor(x, dtype=self.samples.dtype, device=self.samples.device)
        if chunk is None:
            chunk = 1 << 20 if x.is_cuda else 1 << 14
        single = x.ndim == 1
        pts = x[None] if single else x
        lead = pts.shape[:-1]
        flat = pts.reshape(-1, pts.shape[-1])
        self._seed_grid()  # one build, shared by every chunk
        parts = [self._closest_point_chunk(c) for c in flat.split(int(chunk))]
        cp = torch.cat([p for p, _ in parts]) if parts else flat.clone()
        ok = torch.cat([o for _, o in parts]) if parts else torch.zeros(
            0, dtype=torch.bool, device=flat.device)
        cp, ok = cp.reshape(lead + cp.shape[-1:]), ok.reshape(lead)
        return (cp[0], ok[0]) if single else (cp, ok)

    def __call__(self, x):
        x = torch.as_tensor(x, dtype=self.samples.dtype, device=self.samples.device)
        single = x.ndim == 1
        pts = x[None] if single else x
        cp, _ = self.closest_point(pts)
        delta = pts - cp
        dist = torch.sqrt(torch.sum(delta * delta, -1))
        # the sign of (x - cp) . grad(phi)(cp): robust far outside a band
        sgn = torch.sign(torch.sum(delta * self.cf.gradient(cp), -1))
        sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
        out = sgn * dist
        return out[0] if single else out


def reinitialize_newton(phi: MeshField, order: int = 3, upsample: int = 2, maxiters: int = 20,
                        max_cut_cells: Optional[int] = None,
                        on_overflow: str = "warn") -> MeshField:
    """Every node set to ``sign(phi) |x - cp(x)|`` from a fresh
    :class:`NewtonSDF`: a single-pass, O(h^(order+1))-accurate
    reinitialization. ``max_cut_cells`` builds the seed set on the device;
    a cut-cell count above it truncates the seeds, which ``on_overflow``
    reports: ``"warn"`` (default), ``"raise"`` or ``"ignore"``."""
    if on_overflow not in ("warn", "raise", "ignore"):
        raise ValueError(f"on_overflow must be warn/raise/ignore, got {on_overflow!r}")
    sdf = NewtonSDF(phi, order=order, upsample=upsample, maxiters=maxiters,
                    max_cut_cells=max_cut_cells)
    if sdf.overflowed is not None and on_overflow != "ignore" and bool(sdf.overflowed):
        msg = (f"reinitialize_newton: cut-cell count exceeds max_cut_cells={max_cut_cells}; "
               "the seed set is truncated and the reinitialized distances are unreliable; "
               "rebuild with a larger capacity")
        if on_overflow == "raise":
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    dev = phi.values.device
    nodes = torch.stack(phi.grid.dense_coords(dtype=phi.dtype, device=dev), -1).reshape(
        -1, phi.ndim)
    cp, _ = sdf.closest_point(nodes)
    dist = torch.sqrt(torch.sum((nodes - cp) ** 2, -1)).reshape(phi.shape)
    return phi.with_values(torch.sign(phi.values) * dist)


def hausdorff_distance(sdf1: NewtonSDF, sdf2: NewtonSDF) -> torch.Tensor:
    """Symmetric Hausdorff distance between the two zero sets, estimated over
    the interface samples."""

    def one_sided(a: NewtonSDF, b: NewtonSDF):
        pts, valid = a.sample_points()
        d = torch.abs(b(pts))
        return torch.max(torch.where(valid, d, torch.zeros_like(d)))

    return torch.maximum(one_sided(sdf1, sdf2), one_sided(sdf2, sdf1))
