"""Backward of the fused stage on the padded layout (port of
:mod:`lsm_tpu.ops.weno_v2_bwd`): four kernels, each beside its plain torch
version, and the autograd oracle they are held against.

- :func:`fold_ghost_cotangent_fast` (K4, ``csrc/fold_ghosts.cu``; plain
  :func:`fold_ghost_cotangent_plain`, in place) folds the cotangents on a
  padded buffer's ghost shells into its interior, with zero shells, into a
  new buffer: the transpose of the ghost refresh K2.
  :func:`fold_ghost_cotangent` is the same map as the autograd VJP of
  :func:`~.weno_v2.pack_padded` (the oracle).
- :func:`zero_pad_shells` (K5, ``csrc/fold_ghosts.cu``; plain
  :func:`zero_pad_shells_plain`) zeroes the ghost shells in place.
- :func:`stage_backward` (K3, ``csrc/stage_backward.cu``; plain
  :func:`stage_backward_plain`) gives the cotangents of one K1 stage for a
  folded output cotangent: ``dP`` (ghost positions included, the stage reads
  stored ghosts), the streams' ``du``, ``daux`` and ``(dalpha, dbeta,
  dgamma)``. The plain version is the hand WENO5 adjoint
  (:func:`~.stencils.weno5_upwind_fwd_bwd`) plus the transpose of the
  difference tables, with the kernel's arithmetic.
- :func:`stage_backward_terms` (K3', ``csrc/stage_backward.cu``; plain
  :func:`stage_backward_terms_plain`) the same for a K1' stage over any term
  list (advection, normal motion, curvature, eikonal; streamed, constant or
  no coefficients): K3' for the other kinds, then K3 in accumulate mode for
  each advection term (the hand WENO5 adjoint, as JAX keeps it inside a
  mixed list). Its plain version is autograd of the plain stage for the
  other kinds, which have no float32 tie hazard, and the hand adjoint for
  advection. :func:`stage_backward_terms_staged`, for the tests only, is the
  CPU twin of the kernel's factorisation: each output's pieces once, then
  the gather with the kernel's weights.
- K3″, the program branch of K3 and K3' (``csrc/stage_backward.cu``): a
  program term (:mod:`.coef_program`) is evaluated per node in place of
  its streams, has no stream cotangent, and when the caller asks for it
  (``need_dt``) the kernel evaluates the program in forward-mode dual
  numbers for ``dH/dt`` and reduces ``sum g*(-gamma)*dH/dt`` into the
  cotangent of the stage time, a fourth entry of ``dcoef``. The plain
  versions take it from autograd of :func:`~.weno_v2.program_values`.
- :func:`composite_backward_autograd`: ``torch.autograd.grad`` of
  :func:`~.weno_v2.stage_refresh_plain` (stage plus refresh), the oracle
  (counterpart of ``lsm_tpu.ops.weno_v2_bwd._jnp_stage_backward``). In
  float32 it is wrong at WENO tie cells; hold float32 results against it in
  float64.

Every wrapper takes a 3D shape or a 2D one: a 2D field's ``(n0+6, n1+6)``
buffer, the dense 2D stepper's, whose stage (K1's 2D entries) computes the
function of the ``(1, n0, n1)`` embedding with its dummy axis compiled out;
its backward is the 2D entries of the same kernels (two velocity components
and spacings; a program, and K3' 's table, the embedding's,
:func:`~.weno_v2.embedding_2d`) and, on the CPU, the plain versions on the 2D
stencils.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises. Each counts its kernel launches in
``launches``, those of its 2D entry also in ``launches_2d``; K3 and K3'
those with a program term (K3″) also in ``program_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..core import bc as _bc
from . import stencils as st
from . import weno_v2 as v2
from ._build import load_library
from ._launches import bump
from .coef_program import Program

__all__ = [
    "fold_ghost_cotangent",
    "fold_ghost_cotangent_plain",
    "fold_ghost_cotangent_fast",
    "zero_pad_shells_plain",
    "zero_pad_shells",
    "stage_backward_plain",
    "stage_backward",
    "stage_backward_terms_plain",
    "stage_backward_terms",
    "composite_backward_autograd",
]

G = v2.GHOST


def _entry(lib, name: str, shape, dtype):
    """The library's entry ``name`` for a 3D or 2D ``shape`` and ``dtype``:
    ``lib.<name>_f32``, or ``lib.<name>_2d_f64`` and so on."""
    return getattr(lib, f"{name}{'_2d' if len(shape) == 2 else ''}_"
                        f"{'f32' if dtype == torch.float32 else 'f64'}")


# -- K4: ghost-cotangent fold --------------------------------------------------------


def fold_ghost_cotangent(g: torch.Tensor, bcs, shape) -> torch.Tensor:
    """Interior-shaped cotangent: ``g``'s interior plus its ghost-shell
    cotangents folded through the ghost construction, computed as the
    autograd VJP of :func:`~.weno_v2.pack_padded` (exact by construction; the
    oracle of K4)."""
    with torch.enable_grad():
        v = torch.zeros(tuple(shape), dtype=g.dtype, device=g.device, requires_grad=True)
        (out,) = torch.autograd.grad(v2.pack_padded(v, bcs), v, grad_outputs=g)
    return out


def _fold_sources(bc, side: int, k: int, n: int):
    """``(node, weight)`` of each interior node the ghost at distance ``k``
    on ``side`` (0 left, 1 right) of an axis of ``n`` nodes is built from."""
    if isinstance(bc, _bc.Periodic):
        return ((n - 1 - k if side == 0 else k, 1.0),)
    if isinstance(bc, _bc.Symmetry):
        return ((k if side == 0 else n - 1 - k, 1.0),)
    if isinstance(bc, _bc.Extrapolation):
        W = _bc._lagrange_extrap_weights(G, bc.degree)  # row G - k <-> distance k
        return tuple((j if side == 0 else n - 1 - j, float(W[G - k, j]))
                     for j in range(bc.degree + 1))
    raise TypeError(f"unsupported boundary condition {bc!r}")


def fold_ghost_cotangent_plain(g: torch.Tensor, bcs, shape) -> torch.Tensor:
    """Plain version of K4, in place on the padded ``g``: the axes last to
    first (the reverse of the refresh: 2, 1, 0 in 3D, 1, 0 in 2D), each over
    the lines the refresh covers for that axis; per line, left then right
    side, ghost distance 1..3, source node by node: ``src += w * ghost``;
    then the shells are zeroed. Returns ``g``."""
    for ax in reversed(range(len(shape))):
        n = shape[ax]
        line = g[tuple(slice(None) if d <= ax else slice(G, G + m)
                       for d, m in enumerate(shape))]
        for side in (0, 1):
            for k in range(1, G + 1):
                ghost = line.narrow(ax, G - k if side == 0 else G + n - 1 + k, 1)
                for node, w in _fold_sources(bcs[ax][side], side, k, n):
                    line.narrow(ax, G + node, 1).add_(ghost * w)
        line.narrow(ax, 0, G).zero_()
        line.narrow(ax, G + n, G).zero_()
    return g


def fold_ghost_cotangent_fast(g: torch.Tensor, bcs, shape) -> torch.Tensor:
    """K4: a new padded buffer holding ``g``'s interior with the ghost-shell
    cotangents of ``g`` folded into it, and zero shells; ``g`` is left as it
    is. ``shape`` 3D, or 2D (a 2D field's ``(n0+6, n1+6)`` buffer: the
    transpose of K2's 2D entry).

    Replaces ``lsm_tpu.ops.weno_v2_bwd.fold_ghost_cotangent_fast``. CUDA
    tensors go to ``csrc/fold_ghosts.cu`` (one launch: each interior node
    gathers its contributions in the plain version's order), CPU tensors to
    :func:`fold_ghost_cotangent_plain` on a copy. The kernels take what K2
    takes: Periodic and Symmetry on axes of >= 4 nodes, Extrapolation of
    degree <= n - 1 on any axis (one of 1-3 nodes gathers from both faces),
    else ``ValueError``; a degree above 7 takes the table route (the same
    threads, the weights in a device table; one launch, counted in
    ``table_launches`` too).
    """
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"the ghost fold takes a 3D or 2D shape, got {shape}")
    v2._check(g, "g", v2.padded_shape(shape))
    if g.device.type == "cpu":
        return fold_ghost_cotangent_plain(g.clone(), bcs, shape)
    kinds, degrees, weights = v2._ghost_args(bcs, shape)
    table = v2._ghost_table(bcs, shape, g.device, g.dtype)
    if table is not None:
        gf = torch.empty_like(g)
        v2.ghost_table_launch(v2.TABLE_FOLD, g, gf, bcs, shape, table)
        bump(fold_ghost_cotangent_fast, launches=1, launches_2d=len(shape) == 2,
             table_launches=1)
        return gf
    lib = load_library()
    fn = _entry(lib, "fold", shape, g.dtype)
    gf = torch.empty_like(g)
    ctx, stream = v2._on_card(g)
    with ctx:
        code = fn(g.data_ptr(), gf.data_ptr(), *shape, ctypes.addressof(kinds),
                  ctypes.addressof(degrees), ctypes.addressof(weights), stream)
    v2._raise_on(code, lib, "fold_ghosts kernel")
    bump(fold_ghost_cotangent_fast, launches=1, launches_2d=len(shape) == 2)
    return gf


fold_ghost_cotangent_fast.launches = 0
fold_ghost_cotangent_fast.launches_2d = 0  # of the launches, those of the 2D entry
fold_ghost_cotangent_fast.table_launches = 0  # of the launches, those of the table route


# -- K5: shell zeroing -----------------------------------------------------------


def zero_pad_shells_plain(buf: torch.Tensor, shape) -> torch.Tensor:
    """Plain version of K5: zero the ghost slabs of ``buf`` in place (six in
    3D, four in 2D)."""
    for ax, n in enumerate(shape):
        buf.narrow(ax, 0, G).zero_()
        buf.narrow(ax, G + n, G).zero_()
    return buf


def zero_pad_shells(buf: torch.Tensor, shape) -> torch.Tensor:
    """K5: zero the ghost shells of a padded 3D or 2D buffer in place;
    returns ``buf``.

    Replaces ``lsm_tpu.ops.weno_v2_bwd._zero_pad_shells``. CUDA tensors go to
    ``csrc/fold_ghosts.cu`` (one launch over the gaps between the interior
    rows of the flat buffer: 16-byte stores over the head, the tail and the
    gaps between planes, a few lanes a six-element seam between two rows;
    no interior node touched), CPU tensors to :func:`zero_pad_shells_plain`.
    """
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"the shell zeroing takes a 3D or 2D shape, got {shape}")
    v2._check(buf, "buf", v2.padded_shape(shape))
    if buf.device.type == "cpu":
        return zero_pad_shells_plain(buf, shape)
    lib = load_library()
    fn = _entry(lib, "zero_shells", shape, buf.dtype)
    ctx, stream = v2._on_card(buf)
    with ctx:
        code = fn(buf.data_ptr(), *shape, stream)
    v2._raise_on(code, lib, "zero_shells kernel")
    bump(zero_pad_shells, launches=1, launches_2d=len(shape) == 2)
    return buf


zero_pad_shells.launches = 0
zero_pad_shells.launches_2d = 0  # of the launches, those of the 2D entry


# -- K3: stage backward ---------------------------------------------------------------


def _edge_transpose(ddm, ax, inv_h, shape, like):
    """``(c[x] - c[x + e_ax]) * inv_h`` on the padded grid, where ``c[z]``
    sums ``ddm[k]`` of the interior output ``z - (k - 2) e_ax`` over ``k`` in
    order: the transpose of :func:`~.stencils.weno5_pair_diffs`."""
    c = torch.zeros(tuple(s + (1 if d == ax else 0) for d, s in
                          enumerate(v2.padded_shape(shape))), dtype=like.dtype,
                    device=like.device)
    for k in range(6):
        st.shift(c, tuple(k - 2 if d == ax else 0 for d in range(len(shape))), G,
                 shape).add_(ddm[k])
    n = c.shape[ax]
    return (c.narrow(ax, 0, n - 1) - c.narrow(ax, 1, n - 1)) * inv_h


def _advection_backward(P, u, gup, spacing, shape):
    """The hand WENO5 adjoint of one advection term ``sum_d u_d *
    WENO5_d(phi)`` for its cotangent ``gup``: ``(H, dP, du)``, ``dP`` on the
    padded layout."""
    ham, dP, du = 0.0, 0.0, []
    for ax, h in enumerate(spacing):
        dm = st.weno5_pair_diffs(P, ax, float(h), G, shape)
        H, ddm, du_ax = st.weno5_upwind_fwd_bwd(dm, u[ax], gup)
        ham = ham + H
        du.append(du_ax)
        dP = dP + _edge_transpose(ddm, ax, 1.0 / float(h), shape, P)
    return ham, dP, tuple(du)


def _program_coefs(spec, P, spacing, shape, where, need_dt):
    """A program term's coefficient values at ``where`` (detached) and, when
    ``need_dt``, the graph to differentiate them in ``t``:
    ``(values, (t leaf, live values) or None)``."""
    where = where or v2.Where()
    if not (need_dt and spec.coef_static.depends_on_t):
        with torch.no_grad():
            vals = v2.program_values_at(spec, shape, spacing, where.at(where.value), P)
        return vals, None
    t = torch.tensor(where.value, dtype=P.dtype, device=P.device, requires_grad=True)
    with torch.enable_grad():
        live = v2.program_values_at(spec, shape, spacing, where.at(t), P)
    return tuple(v.detach() for v in live), (t, live)


def _dt_of(graph, cotangents, like):
    """``sum_k <cotangent_k, d value_k / dt>`` of :func:`_program_coefs`'
    graph (0 without one)."""
    pairs = [] if graph is None else [(v, c) for v, c in zip(graph[1], cotangents)
                                      if v.requires_grad]
    if not pairs:
        return like.new_zeros(())
    (dt,) = torch.autograd.grad([v for v, _ in pairs], graph[0],
                                grad_outputs=[c for _, c in pairs], allow_unused=True)
    return like.new_zeros(()) if dt is None else dt


def stage_backward_plain(P, u, coeffs, aux, g, spacing, shape, need_du=True,
                         need_daux=True, out=None, where=None, need_dt=False):
    """Plain version of K3, with the kernel's arithmetic: see
    :func:`stage_backward`."""
    shape = tuple(shape)
    alpha, beta, gamma = (float(c) for c in coeffs)
    gi = v2.unpack_padded(g, shape)
    prog = isinstance(u, Program)
    if prog:
        u, graph = _program_coefs(v2.TermSpec("advection", "program", u), P, spacing, shape,
                                  where, need_dt)
        need_du = False
    ham, dPa, du = _advection_backward(P, u, -gamma * gi, spacing, shape)
    dgamma = -(gi * ham).sum()
    extra = [_dt_of(graph, du, dgamma)] if prog else []
    if out is not None:
        zero = torch.zeros_like(dgamma)
        return (out.add_(dPa), (du if need_du else None),
                torch.stack([zero, zero, dgamma, *extra]), None)
    dP = torch.zeros_like(P)
    v2.unpack_padded(dP, shape).copy_(beta * gi)
    dP = dP + dPa
    center = v2.unpack_padded(P, shape)
    dalpha = (gi * v2.unpack_padded(aux, shape)).sum() if aux is not None else gi.new_zeros(())
    dcoef = torch.stack([dalpha, (gi * center).sum(), dgamma, *extra])
    daux = None
    if aux is not None and need_daux:
        daux = torch.empty_like(P)
        v2.unpack_padded(daux, shape).copy_(alpha * gi)
        zero_pad_shells_plain(daux, shape)
    return dP, (du if need_du else None), dcoef, daux


def stage_backward(P: torch.Tensor, u, coeffs,
                   aux: Optional[torch.Tensor], g: torch.Tensor, spacing, shape,
                   need_du: bool = True, need_daux: bool = True,
                   out: Optional[torch.Tensor] = None, where: Optional[v2.Where] = None,
                   need_dt: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]],
                              torch.Tensor, Optional[torch.Tensor]]:
    """K3: cotangents of one K1 stage ``alpha*aux + beta*phi - gamma*u.grad(phi)``.

    ``g`` is the padded cotangent of the stage output after the fold (K4):
    only its interior is read. Returns ``(dP, du, dcoef, daux)``: ``dP`` on
    the whole padded layout (ghost positions included, corner ghosts 0), ``du``
    the three streams' cotangents (``None`` unless ``need_du``), ``dcoef =
    (dalpha, dbeta, dgamma)`` as a 3-vector, ``daux = alpha*g`` on the
    interior with zero shells (``None`` without ``aux`` or ``need_daux``; its
    shells are zeroed by K5). ``coeffs`` are host numbers.

    ``out`` (a padded buffer, the accumulate mode of an advection term inside
    a term list): the advection term's share of ``dP`` is added to ``out``,
    which is returned as ``dP``; nothing is written for ``beta*g`` or
    ``daux`` (``None``), and ``dcoef = (0, 0, dgamma)``.

    K3″: ``u`` may be a 3-component :class:`~.coef_program.Program`,
    evaluated per node at ``where`` (its ``lo``, ``origin`` and host-number
    time ``t``); then ``du`` is ``None`` and ``dcoef`` gains a fourth entry,
    the cotangent of ``t`` (0 unless ``need_dt``).

    A 2D ``shape`` (K1's 2D stage): ``u`` two components (a program stays
    the embedding's three), ``spacing`` and ``where`` the field's, ``du`` two
    components.

    Replaces ``lsm_tpu.ops.weno_v2_bwd.stage_backward`` (without its
    ``prefolded`` argument). CUDA tensors go to ``csrc/stage_backward.cu``,
    CPU tensors to :func:`stage_backward_plain`.
    """
    shape = tuple(shape)
    prog = isinstance(u, Program)
    nd = len(shape)
    if nd not in (2, 3) or len(spacing) != nd or (
            len(u.components) != 3 if prog else len(u) != nd):
        raise ValueError("the stage backward takes a 3D or 2D shape with one spacing and one "
                         "velocity component per axis (a program of 3 components)")
    v2._check(P, "P", v2.padded_shape(shape))
    v2._check(g, "g", v2.padded_shape(shape), like=P)
    for d, ud in enumerate(() if prog else u):
        v2._check(ud, f"u[{d}]", shape, like=P)
    if aux is not None:
        v2._check(aux, "aux", v2.padded_shape(shape), like=P)
    if out is not None:
        v2._check(out, "out", v2.padded_shape(shape), like=P)
        aux = None
    if P.device.type == "cpu":
        return stage_backward_plain(P, u, coeffs, aux, g, spacing, shape, need_du, need_daux,
                                    out, where, need_dt)
    lib = load_library()
    dP = torch.empty_like(P) if out is None else out
    need_du = need_du and not prog
    du = tuple(torch.empty_like(u[0]) for _ in range(nd)) if need_du else None
    daux = torch.empty_like(P) if aux is not None and need_daux else None
    scratch = lib.stage_bwd_scratch if nd == 3 else lib.stage_bwd_scratch_2d
    part = torch.empty(scratch(*shape), dtype=torch.float64, device=P.device)
    dcoef = (torch.zeros if prog else torch.empty)(4 if prog else 3, dtype=P.dtype,
                                                     device=P.device)
    alpha, beta, gamma = (float(c) for c in coeffs)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ctx, stream = v2._on_card(P)
    with ctx:
        if prog:
            need_dt = bool(need_dt and u.depends_on_t)
            term = ((v2.TermSpec("advection", "program", u), ()),)
            if nd == 3:
                tab = v2.stage_table(term, spacing, coeffs, where, shape, P, need_dt)
                axes = ()
            else:  # the embedding's table and the axes each component reads, as K1″ 2D
                tab = v2._table_2d(term, coeffs, spacing, shape, where or v2.Where(), P, need_dt)
                axes = u.axes[1:]
            fn = _entry(lib, "stage_bwd_prog", shape, P.dtype)
            code = fn(P.data_ptr(), g.data_ptr(), ptr(aux), dP.data_ptr(), ptr(daux),
                      part.data_ptr(), dcoef.data_ptr(), *shape, ctypes.addressof(tab),
                      int(out is not None), int(need_dt), *axes, stream)
        else:
            code = _entry(lib, "stage_bwd", shape, P.dtype)(
                P.data_ptr(), g.data_ptr(), *(c.data_ptr() for c in u), ptr(aux), dP.data_ptr(),
                *(ptr(d) for d in (du or (None,) * nd)), ptr(daux), part.data_ptr(),
                dcoef.data_ptr(), *shape, *(1.0 / float(h) for h in spacing), alpha, beta, gamma,
                int(out is not None), stream)
    v2._raise_on(code, lib, "stage_backward kernel")
    bump(stage_backward, launches=1, program_launches=prog, launches_2d=nd == 2)
    if daux is not None:
        zero_pad_shells(daux, shape)
    return dP, du, dcoef, daux


stage_backward.launches = 0
stage_backward.program_launches = 0  # of the launches, K3″'s (a program velocity)
stage_backward.launches_2d = 0  # of the launches, those of the 2D entries



# -- K3': the stage backward of a term list -------------------------------------------


def _stream_slices(terms):
    """Per term, the slice of the flat stream list its streams take."""
    out, k = [], 0
    for _, arrs in terms:
        out.append(slice(k, k + len(arrs)))
        k += len(arrs)
    return out


def stage_backward_terms_plain(P, terms, coeffs, aux, g, spacing, shape, need_dstreams=True,
                               need_daux=True, where=None, need_dt=False):
    """Plain version of K3': see :func:`stage_backward_terms`. The
    normal-motion, curvature and eikonal terms take ``torch.autograd.grad``
    of their plain Hamiltonians (:func:`~.weno_v2.ham_contribution`) for the
    cotangent ``-gamma*g`` (a program term's ``t`` too); each advection
    term the hand WENO5 adjoint of :func:`stage_backward_plain`."""
    shape = tuple(shape)
    terms = v2.as_terms(terms)
    where = where or v2.Where()
    alpha, beta, gamma = (float(c) for c in coeffs)
    gi = v2.unpack_padded(g, shape)
    gup = -gamma * gi
    dP = torch.zeros_like(P)
    v2.unpack_padded(dP, shape).copy_(beta * gi)
    flat = [a for _, arrs in terms for a in arrs]
    dstreams = [None] * len(flat)
    ham = 0.0
    dt = gi.new_zeros(())
    others = [(spec, sl) for (spec, _), sl in zip(terms, _stream_slices(terms))
              if spec.kind != "advection"]
    if others:
        with torch.enable_grad():
            Pv = P.detach().requires_grad_()
            sv = [a.detach().requires_grad_() for a in flat]
            tv = torch.tensor(where.value, dtype=P.dtype, device=P.device,
                              requires_grad=need_dt)
            at = where.at(tv)
            center = v2.unpack_padded(Pv, shape)
            H = 0.0
            for spec, sl in others:
                H = H + v2.ham_contribution(spec, Pv, v2._coef_values(spec, sv[sl], Pv, spacing,
                                                                      shape, at),
                                            center, spacing, shape)
            used = [sv[k] for _, sl in others for k in range(sl.start, sl.stop)]
            grads = torch.autograd.grad(H, [Pv, *used, *([tv] if need_dt else [])],
                                        grad_outputs=gup, allow_unused=True)
        dP = dP + grads[0]
        ham = ham + H.detach()
        it = iter(grads[1:])
        for _, sl in others:
            for k in range(sl.start, sl.stop):
                d = next(it)
                dstreams[k] = torch.zeros_like(flat[k]) if d is None else d
        if need_dt:
            d = next(it)
            dt = dt if d is None else dt + d
    for (spec, arrs), sl in zip(terms, _stream_slices(terms)):
        if spec.kind == "advection":
            graph = None
            if spec.coef_kind == "program":
                arrs, graph = _program_coefs(spec, P, spacing, shape, where, need_dt)
            H, dPa, du = _advection_backward(P, arrs, gup, spacing, shape)
            ham = ham + H
            dP = dP + dPa
            if spec.coef_kind == "program":
                dt = dt + _dt_of(graph, du, dt)
            else:
                dstreams[sl] = du
    center = v2.unpack_padded(P, shape)
    dalpha = (gi * v2.unpack_padded(aux, shape)).sum() if aux is not None else gi.new_zeros(())
    dcoef = torch.stack([dalpha, (gi * center).sum(), -(gi * ham).sum()] + (
        [dt] if any(spec.coef_kind == "program" for spec, _ in terms) else []))
    daux = None
    if aux is not None and need_daux:
        daux = torch.empty_like(P)
        v2.unpack_padded(daux, shape).copy_(alpha * gi)
        zero_pad_shells_plain(daux, shape)
    return dP, (tuple(dstreams) if need_dstreams else None), dcoef, daux


# -- the CPU twin of K3''s staged factorisation ---------------------------------------


def _d2_coef(centre: int, k: int) -> float:
    """Coefficient of offset ``k`` in the second difference centred at
    ``centre``."""
    r = k - centre
    return -2.0 if r == 0 else (1.0 if abs(r) == 1 else 0.0)


def _minmod_sel(x, y):
    """``minmod(x, y)`` and the argument it returned: 0 none, 1 ``x``, 2 ``y``."""
    same = x * y > 0
    first = x.abs() <= y.abs()
    sel = torch.where(same, torch.where(first, 1, 2), 0)
    return torch.where(same, torch.where(first, x, y), torch.zeros_like(x)), sel


def _godunov_pieces(P, specs, vals, gbar, spacing, shape):
    """The Godunov kinds' pieces of every interior output, once each (K3'
    phase 1): ``(dA, dB, sA, sB, dc, ham, dvs)``: per axis the cotangents of
    the ENO2 one-sided derivatives and their minmod branches, the centre's
    direct cotangent, ``H`` and each term's coefficient cotangent."""
    c0 = st._s(P, 0, 0, G, shape)
    A, B, sA, sB = [], [], [], []
    gp2 = gm2 = 0.0
    for d, h in enumerate(spacing):
        # the plain stencils' arithmetic, so that near-ties pick its branches
        h = float(h)
        d2c = st.d2c(P, d, h, G, shape)
        mA, sa = _minmod_sel(st.d2mm(P, d, h, G, shape), d2c)
        mB, sb = _minmod_sel(st.d2pp(P, d, h, G, shape), d2c)
        A.append(st.dm(P, d, h, G, shape) + 0.5 * h * mA)
        B.append(st.dp(P, d, h, G, shape) - 0.5 * h * mB)
        sA.append(sa)
        sB.append(sb)
        gp2 = gp2 + A[d].clamp(min=0) ** 2 + B[d].clamp(max=0) ** 2
        gm2 = gm2 + A[d].clamp(max=0) ** 2 + B[d].clamp(min=0) ** 2
    zero = torch.zeros_like(c0)
    gp = torch.where(gp2 > 0, gp2.clamp(min=0).sqrt(), zero)
    gm = torch.where(gm2 > 0, gm2.clamp(min=0).sqrt(), zero)
    dgp = dgm = dc = ham = zero
    dvs = []
    for spec, v in zip(specs, vals):
        dv = zero
        if spec.kind == "normal":
            # H = max(v, 0) gp + min(v, 0) gm; a tie at v == 0 splits 0.5 / 0.5
            dgp = dgp + gbar * v.clamp(min=0)
            dgm = dgm + gbar * v.clamp(max=0)
            ham = ham + (v.clamp(min=0) * gp + v.clamp(max=0) * gm)
            dv = torch.where(v > 0, gbar * gp,
                             torch.where(v < 0, gbar * gm, 0.5 * gbar * gp + 0.5 * gbar * gm))
        elif spec.coef_kind == "none":
            # s = phi / sqrt(phi^2 + norm^2 dx^2) (0 where that is 0), H = s (norm - 1)
            dx = min(float(h) for h in spacing)
            up = c0 > 0
            norm = torch.where(up, gp, gm)
            denom = (c0 * c0 + norm * norm * dx * dx).sqrt()
            nz = denom != 0
            s = torch.where(nz, c0 / torch.where(nz, denom, 1.0), zero)
            ds = gbar * (norm - 1.0)
            ddenom = torch.where(nz, -ds * c0 / (denom * denom), zero)
            dc = dc + torch.where(nz, ds / torch.where(nz, denom, 1.0), zero)
            dX = ddenom / (2.0 * denom)  # 0/0 where denom == 0, as autodiff's
            dc = dc + dX * (2.0 * c0)
            dnorm = gbar * s + dX * dx * dx * (2.0 * norm)
            dgp = dgp + torch.where(up, dnorm, zero)
            dgm = dgm + torch.where(up, zero, dnorm)
            ham = ham + s * (norm - 1.0)
        else:
            # frozen sign s = v: H = s (norm - 1), norm = |grad+| where s > 0
            up = v > 0
            norm = torch.where(up, gp, gm)
            dgp = dgp + torch.where(up, gbar * v, zero)
            dgm = dgm + torch.where(up, zero, gbar * v)
            ham = ham + v * (norm - 1.0)
            dv = gbar * (norm - 1.0)
        dvs.append(dv)
    dgp2 = torch.where(gp2 > 0, dgp / (2.0 * torch.where(gp2 > 0, gp, 1.0)), zero)
    dgm2 = torch.where(gm2 > 0, dgm / (2.0 * torch.where(gm2 > 0, gm, 1.0)), zero)
    dA = [torch.where(a > 0, dgp2 * (2.0 * a), torch.where(a < 0, dgm2 * (2.0 * a), zero))
          for a in A]
    dB = [torch.where(b < 0, dgp2 * (2.0 * b), torch.where(b > 0, dgm2 * (2.0 * b), zero))
          for b in B]
    return dA, dB, sA, sB, dc, ham, dvs


def _pairs(nd):
    """The axis pairs of the mixed differences: (0, 1), (0, 2), (1, 2) in 3D,
    (0, 1) in 2D."""
    return tuple((i, j) for i in range(nd) for j in range(i + 1, nd))


def _curvature_pieces(P, vals, gbar, spacing, shape):
    """Curvature's pieces of every interior output, once each: the cotangents
    ``(dg, dhd, dhm)`` of its central first, second and mixed differences
    (the mixed ones per pair of :func:`_pairs`), ``H`` and each term's
    coefficient cotangent."""
    nd = len(shape)
    pair = _pairs(nd)
    h = [float(x) for x in spacing]
    c0 = st._s(P, 0, 0, G, shape)
    g = [st.d0(P, d, h[d], G, shape) for d in range(nd)]
    hd = [st.d2c(P, d, h[d], G, shape) for d in range(nd)]
    hm = [st.d2_mixed(P, i, j, h[i], h[j], G, shape) for i, j in pair]
    nrmsq, lap, quad = 0.0, 0.0, 0.0
    for d in range(nd):  # the plain curvature's order
        nrmsq = nrmsq + g[d] * g[d]
        lap = lap + hd[d]
    for i in range(nd):
        quad = quad + g[i] * g[i] * hd[i]
        for m, (a, b) in enumerate(pair):
            if a == i:
                quad = quad + 2.0 * g[a] * g[b] * hm[m]
    safe = nrmsq >= torch.finfo(P.dtype).eps
    zero = torch.zeros_like(c0)
    ns = torch.where(safe, nrmsq, 1.0)
    root = ns.sqrt()
    D = ns * root
    N = lap * ns - quad
    kap = torch.where(safe, N / D, zero)
    nrm = torch.where(nrmsq > 0, nrmsq.clamp(min=0).sqrt(), zero)
    dkap = dnrm = ham = zero
    dvs = []
    for b in vals:  # H = (b kappa) |grad|
        dkap = dkap + gbar * nrm * b
        dnrm = dnrm + gbar * (b * kap)
        ham = ham + b * kap * nrm
        dvs.append(gbar * nrm * kap)
    dK = torch.where(safe, dkap, zero)
    dN = dK / D
    dD = -dK * N / (D * D)
    dlap = dN * ns
    dquad = -dN
    dnrmsq = (torch.where(safe, dN * lap + dD * (1.5 * root), zero)
              + torch.where(nrmsq > 0, dnrm / (2.0 * torch.where(nrmsq > 0, nrm, 1.0)), zero))
    dhd = [dquad * (g[d] * g[d]) + dlap for d in range(nd)]
    dg = []
    for d in range(nd):
        dgd = dquad * (2.0 * g[d] * hd[d])
        for m, (i, j) in enumerate(pair):
            if i == d:
                dgd = dgd + dquad * (2.0 * g[j] * hm[m])
            if j == d:
                dgd = dgd + dquad * (2.0 * g[i] * hm[m])
        dg.append(dgd + (2.0 * g[d]) * dnrmsq)
    dhm = [dquad * (2.0 * g[i] * g[j]) for i, j in pair]
    return dg, dhd, dhm, ham, dvs


def stage_backward_terms_staged(P, terms, coeffs, aux, g, spacing, shape, need_dstreams=True,
                                need_daux=True, where=None, need_dt=False):
    """The CPU twin of K3''s factorisation, for the tests: each interior
    output's Godunov pieces (per axis ``dA``, ``dB`` and the minmod branches)
    and curvature pieces (``dg``, ``dhd``, ``dhm``) are evaluated once, then
    ``dP`` gathers them with the weights of the kernel's phase 2. Returns
    what :func:`stage_backward_terms_plain` returns (advection terms take the
    same hand adjoint)."""
    shape = tuple(shape)
    nd = len(shape)
    terms = v2.as_terms(terms)
    where = where or v2.Where()
    alpha, beta, gamma = (float(c) for c in coeffs)
    gi = v2.unpack_padded(g, shape)
    gbar = -gamma * gi
    h = [float(x) for x in spacing]
    dP = torch.zeros_like(P)
    v2.unpack_padded(dP, shape).copy_(beta * gi)
    flat = [a for _, arrs in terms for a in arrs]
    dstreams = [None] * len(flat)
    ham = 0.0
    dt = gi.new_zeros(())
    god, curv = [], []  # (term index, spec, coefficient values, program graph)
    for n, (spec, arrs) in enumerate(terms):
        if spec.kind == "advection":
            continue
        graph = None
        if spec.coef_kind == "program":
            vals, graph = _program_coefs(spec, P, spacing, shape, where, need_dt)
        else:
            vals = v2._coef_values(spec, arrs, P, spacing, shape, where)
        (curv if spec.kind == "curvature" else god).append((n, spec, vals[0] if vals else None,
                                                            graph))
    slices = _stream_slices(terms)

    def spread(n, dv, graph):  # a term's coefficient cotangent: its stream's, or dt
        nonlocal dt
        if graph is not None:
            dt = dt + _dt_of(graph, (dv,), dt)
        elif terms[n][0].coef_kind == "stream":
            dstreams[slices[n].start] = dv

    def send(w, d, k):  # what every output y sends to P[y + k e_d]
        st._s(dP, d, k, G, shape).add_(w)

    if god:
        dA, dB, sA, sB, dc, H, dvs = _godunov_pieces(P, [s for _, s, _, _ in god],
                                                     [v for _, _, v, _ in god], gbar, spacing,
                                                     shape)
        ham = ham + H
        for (n, _, _, graph), dv in zip(god, dvs):
            spread(n, dv, graph)
        send(dc, 0, 0)
        for d in range(nd):
            inv_h, hh = 1.0 / h[d], 0.5 * h[d] / (h[d] * h[d])
            for k in range(-2, 3):
                w = (dA[d] * inv_h - dB[d] * inv_h if k == 0 else
                     -dA[d] * inv_h if k == -1 else dB[d] * inv_h if k == 1 else 0.0)
                cA = torch.where(sA[d] == 1, _d2_coef(-1, k), torch.where(sA[d] == 2,
                                                                         _d2_coef(0, k), 0.0))
                cB = torch.where(sB[d] == 1, _d2_coef(1, k), torch.where(sB[d] == 2,
                                                                        _d2_coef(0, k), 0.0))
                send(w + dA[d] * hh * cA - dB[d] * hh * cB, d, k)
    if curv:
        dg, dhd, dhm, H, dvs = _curvature_pieces(P, [v for _, _, v, _ in curv], gbar, spacing,
                                                 shape)
        ham = ham + H
        for (n, _, _, graph), dv in zip(curv, dvs):
            spread(n, dv, graph)
        for d in range(nd):
            inv_hh, inv_2h = 1.0 / (h[d] * h[d]), 1.0 / (2.0 * h[d])
            send(-2.0 * dhd[d] * inv_hh, d, 0)
            send(dg[d] * inv_2h + dhd[d] * inv_hh, d, 1)
            send(-dg[d] * inv_2h + dhd[d] * inv_hh, d, -1)
        for m, (i, j) in enumerate(_pairs(nd)):
            w = dhm[m] / (4.0 * h[i] * h[j])
            for si in (-1, 1):
                for sj in (-1, 1):
                    off = [0] * nd
                    off[i], off[j] = si, sj
                    st.shift(dP, tuple(off), G, shape).add_(w if si * sj > 0 else -w)
    for (spec, arrs), sl in zip(terms, slices):
        if spec.kind == "advection":
            graph = None
            if spec.coef_kind == "program":
                arrs, graph = _program_coefs(spec, P, spacing, shape, where, need_dt)
            H, dPa, du = _advection_backward(P, arrs, gbar, spacing, shape)
            ham = ham + H
            dP = dP + dPa
            if spec.coef_kind == "program":
                dt = dt + _dt_of(graph, du, dt)
            else:
                dstreams[sl] = du
    for k, a in enumerate(flat):  # a stream the cotangent does not reach
        if dstreams[k] is None:
            dstreams[k] = torch.zeros_like(a)
    center = v2.unpack_padded(P, shape)
    dalpha = (gi * v2.unpack_padded(aux, shape)).sum() if aux is not None else gi.new_zeros(())
    dcoef = torch.stack([dalpha, (gi * center).sum(), -(gi * ham).sum()] + (
        [dt] if any(spec.coef_kind == "program" for spec, _ in terms) else []))
    daux = None
    if aux is not None and need_daux:
        daux = torch.empty_like(P)
        v2.unpack_padded(daux, shape).copy_(alpha * gi)
        zero_pad_shells_plain(daux, shape)
    return dP, (tuple(dstreams) if need_dstreams else None), dcoef, daux


def stage_backward_terms(P: torch.Tensor, terms, coeffs, aux: Optional[torch.Tensor],
                         g: torch.Tensor, spacing, shape, need_dstreams: bool = True,
                         need_daux: bool = True, where: Optional[v2.Where] = None,
                         need_dt: bool = False):
    """K3': cotangents of one K1' stage ``alpha*aux + beta*phi - gamma*sum_n
    H_n`` over the term list ``terms`` (any list :func:`~.weno_v2.fused_stage`
    takes: kinds advection, normal, curvature, eikonal; coefficients
    streamed, constant or none; up to 16 terms).

    ``g`` as for :func:`stage_backward` (folded by K4, interior read).
    Returns ``(dP, dstreams, dcoef, daux)`` in K3's layout, ``dstreams`` one
    cotangent per stream of the list in order (``None`` unless
    ``need_dstreams``); constant and program coefficients get none. With a
    program term (K3″, evaluated at ``where``) ``dcoef`` gains a fourth
    entry, the cotangent of the stage time (0 unless ``need_dt``).

    A 2D ``shape``: the term list of K1's 2D stage (streams 2D, an advection
    velocity two components, programs the embedding's), ``spacing`` and
    ``where`` the field's; K3''s 2D entry takes the embedding's table.

    Replaces the term-kind branch of ``lsm_tpu.ops.weno_v2_bwd.stage_backward``
    (its per-part ``jax.vjp``). CUDA tensors go to ``csrc/stage_backward.cu``:
    one K3' launch (and its reduction) for the normal, curvature and eikonal
    terms, ``beta*g`` and ``daux``, then K3 in accumulate mode for each
    advection term; K5 zeroes ``daux``'s shells. CPU tensors go to
    :func:`stage_backward_terms_plain`.
    """
    shape = tuple(shape)
    nd = len(shape)
    if nd not in (2, 3) or len(spacing) != nd:
        raise ValueError("the stage backward takes a 3D or 2D shape and one spacing per axis")
    terms = v2.as_terms(terms)
    v2._check(P, "P", v2.padded_shape(shape))
    v2._check(g, "g", v2.padded_shape(shape), like=P)
    v2.check_terms(terms, P, shape, velocity=nd)
    if aux is not None:
        v2._check(aux, "aux", v2.padded_shape(shape), like=P)
    if P.device.type == "cpu":
        return stage_backward_terms_plain(P, terms, coeffs, aux, g, spacing, shape,
                                          need_dstreams, need_daux, where, need_dt)
    lib = load_library()
    fn = _entry(lib, "stage_bwd_terms", shape, P.dtype)
    scratch = lib.stage_bwd_terms_scratch if nd == 3 else lib.stage_bwd_terms_scratch_2d
    dP = torch.empty_like(P)
    daux = torch.empty_like(P) if aux is not None and need_daux else None
    part = torch.empty(scratch(*shape), dtype=torch.float64, device=P.device)
    has_prog = any(spec.coef_kind == "program" for spec, _ in terms)
    dcoef = torch.empty(4, dtype=P.dtype, device=P.device)
    flat = [a for _, arrs in terms for a in arrs]
    dstreams = [None] * len(flat)
    outs = (ctypes.c_void_p * v2.MAX_TERMS)()
    for e, ((spec, arrs), sl) in enumerate(zip(terms, _stream_slices(terms))):
        if spec.kind != "advection" and arrs and need_dstreams:
            dstreams[sl.start] = torch.empty_like(arrs[0])
            outs[e] = dstreams[sl.start].data_ptr()
    if nd == 3:
        tab = v2.stage_table(terms, spacing, coeffs, where, shape, P, need_dt)
    else:
        tab = v2._table_2d(terms, coeffs, spacing, shape, where or v2.Where(), P, need_dt)
    ctx, stream = v2._on_card(P)
    with ctx:
        code = fn(P.data_ptr(), g.data_ptr(), None if aux is None else aux.data_ptr(),
                  dP.data_ptr(), None if daux is None else daux.data_ptr(), part.data_ptr(),
                  dcoef.data_ptr(), *shape, ctypes.addressof(tab), ctypes.addressof(outs),
                  int(bool(need_dt)), stream)
    v2._raise_on(code, lib, "stage_backward_terms kernel")
    bump(stage_backward_terms, launches=1, program_launches=has_prog, launches_2d=nd == 2)
    dcoef = dcoef if has_prog else dcoef[:3]
    for (spec, arrs), sl in zip(terms, _stream_slices(terms)):
        if spec.kind == "advection":
            prog = spec.coef_kind == "program"
            _, du, dc, _ = stage_backward(P, spec.coef_static if prog else arrs, coeffs, None, g,
                                          spacing, shape, need_du=need_dstreams, out=dP,
                                          where=where, need_dt=need_dt)
            dcoef = dcoef + (dc if len(dc) == len(dcoef) else torch.cat([dc, dc.new_zeros(1)]))
            if need_dstreams and not prog:
                dstreams[sl] = du
    if daux is not None:
        zero_pad_shells(daux, shape)
    return dP, (tuple(dstreams) if need_dstreams else None), dcoef, daux


stage_backward_terms.launches = 0
stage_backward_terms.program_launches = 0  # of the launches, those with a program term
stage_backward_terms.launches_2d = 0  # of the launches, those of the 2D entry


def composite_backward_autograd(P, terms, coeffs, aux, g, bcs, spacing, shape, where=None):
    """``torch.autograd.grad`` of :func:`~.weno_v2.stage_refresh_plain` (stage
    plus ghost refresh) for the raw, unfolded padded output cotangent ``g``:
    ``(dP, dstreams, dcoef, daux)`` as :func:`stage_backward` returns them
    (``dstreams`` one per stream of ``terms``, a term list or three velocity
    tensors; ``daux`` ``None`` without ``aux``; with a program term, at
    ``where``, ``dcoef`` ends with the stage time's cotangent). The oracle of
    K4 followed by K3, K3' or K3″; run it in float64."""
    terms = v2.as_terms(terms)
    where = where or v2.Where()
    prog = any(spec.coef_kind == "program" for spec, _ in terms)
    with torch.enable_grad():
        Pv = P.detach().requires_grad_()
        tv = tuple((spec, tuple(a.detach().requires_grad_() for a in arrs))
                   for spec, arrs in terms)
        sv = [a for _, arrs in tv for a in arrs]
        cv = [torch.tensor(float(c), dtype=P.dtype, device=P.device, requires_grad=True)
              for c in (*coeffs, where.value)]
        av = None if aux is None else aux.detach().requires_grad_()
        out = v2.stage_refresh_plain(Pv, tv, cv[:3], av, bcs, spacing, shape,
                                     where.at(cv[3]))
        inputs = [Pv, *sv, *cv] + ([] if av is None else [av])
        grads = torch.autograd.grad(out, inputs, grad_outputs=g, allow_unused=True)
    ns = len(sv)
    dP, dstreams, dc = grads[0], tuple(grads[1:1 + ns]), grads[1 + ns:5 + ns]
    dcoef = torch.stack([d if d is not None else P.new_zeros(()) for d in dc[:4 if prog else 3]])
    return dP, dstreams, dcoef, (grads[5 + ns] if av is not None else None)
