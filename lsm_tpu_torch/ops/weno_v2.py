"""Persistent padded layout and the two kernels of the fused advection path
(port of :mod:`lsm_tpu.ops.weno_v2`).

Layout: the level set lives in one ``(n0+6, n1+6, n2+6)`` buffer with 3 ghost
layers on every axis (WENO5's reach); a 2D field in its own ``(n0+6, n1+6)``
buffer, the 2D band's layout (JAX runs a 2D field as the ``(1, n0, n1)``
embedding, whose dummy axis stores six ghost copies of the plane). The TPU
layout's 8-row sublane pad, its lane-roll view and its ``n2 % 128`` rule are
TPU constraints and are not kept: every shell is stored, so a stage kernel
reads plain neighbours.

Kernels, each beside its plain torch version (used for CPU tensors, by the
tests and by the on-card comparison in ``chip_smoke.py``):

- :func:`fused_stage` (K1, ``csrc/weno_stage.cu``; plain :func:`stage_plain`)
  writes ``alpha*aux + beta*phi - gamma*sum_n H_n`` into the interior of a
  fresh padded buffer, ghost shells left stale. The terms ``H_n`` are WENO5
  advection, Godunov/ENO2 normal motion, mean-curvature motion and eikonal
  reinitialization (frozen or recomputed sign), summed in list order; the
  per-node Hamiltonians are ``csrc/hamiltonians.cuh``, shared with K6. A
  coefficient is streamed, a constant, none (the recomputed eikonal sign)
  or a traced coordinate program (K1″, :mod:`.coef_program`), which the
  kernel evaluates per node at ``lo + (origin + i)*h`` and time ``t``. On a
  2D field it computes the embedding's function on the 2D layout
  (``csrc/weno_stage_2d.cu``): its term list is the 2D stage's (see
  :func:`fused_stage`).
- :func:`refresh_ghosts_fast` (K2, ``csrc/refresh_ghosts.cu``; plain
  :func:`refresh_ghosts_plain`) rewrites the ghost shells in place from the
  interior as axis 0, then axis 1, then axis 2 would, so corner ghosts equal
  ``pad_ghost(values, bcs, 3)`` (every axis in one launch);
  :func:`refresh_axis_fast` is one of the three 3D phases alone (plain
  :func:`refresh_axis_plain`).
- :func:`fused_step_stage` is K1 + K2 as a ``torch.autograd.Function``
  whose backward runs K4, then K3 (one advection term) or K3' (any other
  term list), then K5 (:mod:`.weno_v2_bwd`), in 3D or on a 2D field's
  layout (their 2D entries).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises. Each counts its kernel launches in
``launches``; K1 also counts those of its term-list entry in
``kinds_launches`` and those with a program term (K1″) in
``program_launches``, K1 and K2 those of their 2D entries in
``launches_2d``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..core import bc as _bc
from ..geometry import queries as geo
from . import stencils as st
from .coef_program import OPCODES, Program
from .coef_program import MAX_CONSTS as _MAX_CONSTS
from .coef_program import MAX_OPS as _MAX_OPS
from .coef_program import MAX_TABLES as _MAX_TABLES
from ._build import load_library
from ._launches import bump

__all__ = [
    "GHOST",
    "padded_shape",
    "pack_padded",
    "unpack_padded",
    "refresh_ghosts",
    "refresh_axis_plain",
    "refresh_ghosts_plain",
    "refresh_ghosts_fast",
    "refresh_axis_fast",
    "embedding_2d",
    "programs_2d",
    "node_coords",
    "stage_plain",
    "stage_reference",
    "stage_route",
    "fused_stage",
    "stage_refresh_plain",
    "fused_step_stage",
    "TermSpec",
    "Where",
    "KINDS",
    "MAX_TERMS",
    "ADVECTION",
    "as_terms",
    "resolve_terms",
    "program_values",
    "program_values_at",
    "ham_contribution",
    "gradient_reason",
]

GHOST = st.PAD_WENO5  # 3 ghost layers on every axis
_MAX_DEGREE = 7  # the by-value weights' degree; a higher one takes the table route
_DTYPES = (torch.float32, torch.float64)


def padded_shape(shape) -> Tuple[int, ...]:
    return tuple(n + 2 * GHOST for n in shape)


def pack_padded(values: torch.Tensor, bcs) -> torch.Tensor:
    """Interior values -> persistent padded layout with every ghost filled."""
    return _bc.pad_ghost(values, bcs, GHOST).contiguous()


def unpack_padded(padded: torch.Tensor, shape) -> torch.Tensor:
    """The interior of a padded buffer (a view)."""
    return padded[tuple(slice(GHOST, GHOST + n) for n in shape)]


# -- argument checks shared by both wrappers --------------------------------------


def _check(x: torch.Tensor, name: str, shape, like: Optional[torch.Tensor] = None):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on {x.device}; only cpu and cuda are supported")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} has dtype {x.dtype}; float32 or float64 required")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if like is not None and (x.device != like.device or x.dtype != like.dtype):
        raise ValueError(
            f"{name} is {x.dtype} on {x.device}, but the state is "
            f"{like.dtype} on {like.device}")


def _on_card(x: torch.Tensor):
    """``(context, stream)`` for a launch on ``x``'s card: a context that
    makes the card current where it is not, and the raw handle of its
    current stream (what torch's generated launchers read; a few
    microseconds cheaper a call than ``torch.cuda.device`` and
    ``current_stream``, which matters to a kernel of a few microseconds)."""
    index = x.device.index
    ctx = (contextlib.nullcontext() if index == torch.cuda.current_device()
           else torch.cuda.device(index))
    return ctx, torch._C._cuda_getCurrentRawStream(index)


def _raise_on(code: int, lib, what: str):
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} ({lib.error_string(code)})")


# -- K2: ghost-shell refresh -------------------------------------------------------


def _shell_slices(ax: int, shape, side: str):
    """Index of one axis's ghost shell in the padded buffer: the earlier axes
    span their full padded extent (their ghosts are already fresh), the later
    ones their interior only — the ``pad_ghost`` composition order."""
    sl = []
    for d, n in enumerate(shape):
        if d < ax:
            sl.append(slice(None))
        elif d > ax:
            sl.append(slice(GHOST, GHOST + n))
        else:
            sl.append(slice(0, GHOST) if side == "left" else slice(GHOST + n, None))
    return tuple(sl)


def refresh_axis_plain(padded: torch.Tensor, bcs, shape, ax: int) -> torch.Tensor:
    """Rewrite the two ghost shells of axis ``ax`` from the lines through
    them, in place (one of K2's three phases). Returns ``padded``."""
    src = [slice(None) if d < ax else slice(GHOST, GHOST + m) for d, m in enumerate(shape)]
    line = padded[tuple(src)]
    left = _bc._ghost_block(line, bcs[ax][0], ax, GHOST, "left")
    right = _bc._ghost_block(line, bcs[ax][1], ax, GHOST, "right")
    padded[_shell_slices(ax, shape, "left")] = left
    padded[_shell_slices(ax, shape, "right")] = right
    return padded


def refresh_ghosts_plain(padded: torch.Tensor, bcs, shape) -> torch.Tensor:
    """Rewrite every ghost shell of ``padded`` from its interior, in place
    (plain version of K2). Returns ``padded``."""
    for ax in range(len(shape)):
        refresh_axis_plain(padded, bcs, shape, ax)
    return padded


def refresh_ghosts(padded: torch.Tensor, bcs, shape) -> torch.Tensor:
    """Functional ghost refresh: a new buffer whose shells are recomputed."""
    return refresh_ghosts_plain(padded.clone(), bcs, shape)


_BC_CODES = {_bc.Periodic: 0, _bc.Symmetry: 1, _bc.Extrapolation: 2}


def _ghost_args(bcs, shape):
    """Per axis and side: BC kind code, extrapolation degree, and the weights
    ``w[axis][side][k-1][j]`` of node ``j`` (from the boundary inward) for the
    ghost at distance ``k``, computed in float64 on the host. An axis of
    ``n`` nodes takes ``Extrapolation(d)`` for ``d + 1 <= n`` (so a one-node
    axis takes ``Extrapolation(0)``: its ghosts are copies of the node),
    Periodic and Symmetry for ``n >= 4``. The weights hold degrees up to
    ``_MAX_DEGREE``; a side of higher degree leaves its row 0 and the
    launches take the table route (:func:`_ghost_table`). Cached per BCs and
    shape (the arrays are read, never written, by the launches)."""
    return _ghost_args_of(tuple(tuple(pair) for pair in bcs), tuple(int(n) for n in shape))


@functools.lru_cache(maxsize=64)
def _ghost_args_of(bcs, shape):
    kinds = (ctypes.c_int * 6)()
    degrees = (ctypes.c_int * 6)()
    weights = (ctypes.c_double * (6 * GHOST * (_MAX_DEGREE + 1)))()
    for ax, n in enumerate(shape):
        for side in range(2):
            b = bcs[ax][side]
            code = _BC_CODES.get(type(b))
            if code is None:
                raise TypeError(f"unsupported boundary condition {b!r}")
            if code != 2 and n < GHOST + 1:
                raise ValueError(f"axis {ax} has {n} nodes; the ghost refresh needs >= "
                                 f"{GHOST + 1} for {b} ghosts")
            kinds[2 * ax + side] = code
            if code == 2:
                P = b.degree
                if P + 1 > n:
                    raise ValueError(
                        f"Extrapolation({P}) on axis {ax} with {n} nodes: the ghost "
                        f"refresh takes degree + 1 <= n")
                degrees[2 * ax + side] = P
                if P > _MAX_DEGREE:
                    continue
                W = _bc._lagrange_extrap_weights(GHOST, P)  # row g <-> k = 3 - g
                for k in range(1, GHOST + 1):
                    base = ((2 * ax + side) * GHOST + (k - 1)) * (_MAX_DEGREE + 1)
                    for j in range(P + 1):
                        weights[base + j] = float(W[GHOST - k, j])
    return kinds, degrees, weights


def _ghost_table(bcs, shape, device, dtype=torch.float64):
    """The weight table of the route for a degree above ``_MAX_DEGREE`` (the
    by-value kernels' thread bodies reading it in place): ``(table, dmax)``,
    ``table`` a tensor of ``dtype`` on ``device`` with the weight of node
    ``j`` for the ghost at distance ``k`` of side ``a = 2 axis + side`` at
    ``[(a*3 + k-1)*(dmax+1) + j]``, the float64 weight rounded once;
    ``None`` when every degree fits the by-value weights. Built once per
    BCs, shape, device and dtype."""
    return _ghost_table_of(tuple(tuple(pair) for pair in bcs), tuple(int(n) for n in shape),
                           torch.device(device), dtype)


@functools.lru_cache(maxsize=64)
def _ghost_table_of(bcs, shape, device, dtype):
    dmax = max((b.degree for pair in bcs for b in pair if isinstance(b, _bc.Extrapolation)),
               default=0)
    if dmax <= _MAX_DEGREE:
        return None
    table = np.zeros((2 * len(shape), GHOST, dmax + 1))
    for ax in range(len(shape)):
        for side in range(2):
            b = bcs[ax][side]
            if isinstance(b, _bc.Extrapolation):
                W = _bc._lagrange_extrap_weights(GHOST, b.degree)  # row g <-> k = 3 - g
                for k in range(1, GHOST + 1):
                    table[2 * ax + side, k - 1, :b.degree + 1] = W[GHOST - k]
    return torch.as_tensor(table.ravel()).to(device=device, dtype=dtype), dmax


TABLE_REFRESH, TABLE_FOLD = 0, 1  # the ops of ghost_table_launch


def ghost_table_launch(op: int, g: Optional[torch.Tensor], padded: torch.Tensor, bcs, shape,
                       table, axis_lo: int = 0, axis_hi: Optional[int] = None,
                       flags: Optional[torch.Tensor] = None):
    """One launch of the table route on the card: ``TABLE_REFRESH`` K2's
    axes ``[axis_lo, axis_hi)`` on ``padded`` in place (all of them: its 3D
    or 2D entry, or with K7's ``flags`` K7's; one: its single-axis entry),
    ``TABLE_FOLD`` K4's fold of ``g`` into ``padded``. ``table`` is
    :func:`_ghost_table`'s pair in ``padded``'s dtype."""
    kinds, degrees, weights = _ghost_args(bcs, shape)
    lib = load_library()
    f32 = padded.dtype == torch.float32
    dims = tuple(shape) + (0,) * (3 - len(shape))
    w, dmax = table
    args = (ctypes.addressof(kinds), ctypes.addressof(degrees), ctypes.addressof(weights),
            w.data_ptr(), dmax)
    ctx, stream = _on_card(padded)
    with ctx:
        if op == TABLE_FOLD:
            fn = lib.fold_table_f32 if f32 else lib.fold_table_f64
            code = fn(g.data_ptr(), padded.data_ptr(), len(shape), *dims, *args, stream)
        else:
            fn = lib.refresh_table_f32 if f32 else lib.refresh_table_f64
            code = fn(padded.data_ptr(), len(shape), *dims, axis_lo,
                      len(shape) if axis_hi is None else axis_hi, *args,
                      None if flags is None else flags.data_ptr(), stream)
    _raise_on(code, lib, "fold_table kernel" if op == TABLE_FOLD else "refresh_table kernel")


def refresh_ghosts_fast(padded: torch.Tensor, bcs, shape) -> torch.Tensor:
    """K2: refresh the ghost shells of a padded 3D or 2D buffer in place.

    Replaces ``lsm_tpu.ops.weno_v2.refresh_ghosts_fast``. CUDA tensors go to
    ``csrc/refresh_ghosts.cu`` (one launch, 3D or 2D, whose edge and corner
    ghosts recompute the earlier axes' values they read, bit for bit
    ``pad_ghost``'s), CPU tensors to :func:`refresh_ghosts_plain`. An
    ``Extrapolation`` of degree above 7 takes the table route (the same
    threads, the weights in a device table; one launch, counted in
    ``table_launches`` too). Returns ``padded``.
    """
    shape = tuple(shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"the ghost refresh takes a 3D or 2D shape, got {shape}")
    _check(padded, "padded", padded_shape(shape))
    kinds, degrees, weights = _ghost_args(bcs, shape)
    if padded.device.type == "cpu":
        return refresh_ghosts_plain(padded, bcs, shape)
    table = _ghost_table(bcs, shape, padded.device, padded.dtype)
    if table is not None:
        ghost_table_launch(TABLE_REFRESH, None, padded, bcs, shape, table)
        bump(refresh_ghosts_fast, launches=1, launches_2d=len(shape) == 2, table_launches=1)
        return padded
    lib = load_library()
    f32 = padded.dtype == torch.float32
    if len(shape) == 3:
        fn = lib.refresh_f32 if f32 else lib.refresh_f64
    else:
        fn = lib.refresh_2d_f32 if f32 else lib.refresh_2d_f64
    ctx, stream = _on_card(padded)
    with ctx:
        code = fn(padded.data_ptr(), *shape, ctypes.addressof(kinds),
                  ctypes.addressof(degrees), ctypes.addressof(weights), stream)
    _raise_on(code, lib, "refresh_ghosts kernel")
    bump(refresh_ghosts_fast, launches=1, launches_2d=len(shape) == 2)
    return padded


refresh_ghosts_fast.launches = 0
refresh_ghosts_fast.launches_2d = 0  # of the launches, those of the 2D entry
refresh_ghosts_fast.table_launches = 0  # of the launches, those of the table route


def refresh_axis_fast(padded: torch.Tensor, bcs, shape, ax: int) -> torch.Tensor:
    """K2's single-axis entry: one of its three phases, the two shells of
    axis ``ax`` in place (as :func:`refresh_axis_plain`). The sharded
    refresh runs it for the axes a mesh leaves unsharded. CUDA tensors go to
    ``csrc/refresh_ghosts.cu`` (one launch: a thread a line and its six
    ghosts on axes 0 and 1, a lane a ghost along the seams between rows on
    axis 2), CPU tensors to :func:`refresh_axis_plain`; a degree above 7
    takes the table route (one launch, ``table_launches``). Returns
    ``padded``."""
    shape = tuple(shape)
    if len(shape) != 3 or ax not in (0, 1, 2):
        raise ValueError(f"the ghost refresh is 3D only, got shape {shape} and axis {ax}")
    _check(padded, "padded", padded_shape(shape))
    kinds, degrees, weights = _ghost_args(bcs, shape)
    if padded.device.type == "cpu":
        return refresh_axis_plain(padded, bcs, shape, ax)
    table = _ghost_table(bcs, shape, padded.device, padded.dtype)
    if table is not None:
        ghost_table_launch(TABLE_REFRESH, None, padded, bcs, shape, table, ax, ax + 1)
        bump(refresh_axis_fast, launches=1, table_launches=1)
        return padded
    lib = load_library()
    fn = lib.refresh_axis_f32 if padded.dtype == torch.float32 else lib.refresh_axis_f64
    ctx, stream = _on_card(padded)
    with ctx:
        code = fn(padded.data_ptr(), *shape, ax, ctypes.addressof(kinds),
                  ctypes.addressof(degrees), ctypes.addressof(weights), stream)
    _raise_on(code, lib, "refresh_axis kernel")
    bump(refresh_axis_fast, launches=1)
    return padded


refresh_axis_fast.launches = 0
refresh_axis_fast.table_launches = 0  # of the launches, those of the table route


# -- K1: fused RK stage -------------------------------------------------------------

KINDS = ("advection", "normal", "curvature", "eikonal")
MAX_TERMS = 16  # the kernels' term table (a by-value kernel parameter)
_KIND_CODES = {k: i for i, k in enumerate(KINDS)}
_COEF_CODES = {"stream": 0, "const": 1, "none": 2, "program": 3}
#: the coefficient kinds the kernels take, per term kind
_KERNEL_COEFS = {"advection": ("stream", "program"), "normal": ("stream", "const", "program"),
                 "curvature": ("stream", "const", "program"),
                 "eikonal": ("stream", "none", "program")}


class TermSpec:
    """Description of one fused term: ``kind`` (one of :data:`KINDS`) and
    ``coef_kind``, one of

    - ``"stream"``: ``n_streams`` coefficient tensors (3 velocity components
      for advection, 1 for a scalar coefficient or a frozen eikonal sign),
    - ``"const"``: the number ``coef_static``,
    - ``"program"``: a coordinate callable traced into the
      :class:`~.coef_program.Program` ``coef_static``, which the kernels
      evaluate per node (K1″, K3″, K6″): nothing is streamed for it,
    - ``"analytic"``: a coordinate callable ``coef_static(xs, t)`` that did
      not trace (``reason`` says why), which the steppers evaluate into
      streamed tensors at each stage time (:func:`resolve_terms`),
    - ``"none"``: the eikonal term with its sign recomputed from phi.
    """

    __slots__ = ("kind", "coef_kind", "coef_static", "n_streams", "reason")

    def __init__(self, kind, coef_kind, coef_static=None, n_streams=0, reason=None):
        self.kind = kind
        self.coef_kind = coef_kind
        self.coef_static = coef_static
        self.n_streams = n_streams
        self.reason = reason

    @property
    def route(self):
        """How the coefficient reaches the kernels: ``"program"`` (in-kernel),
        ``"stream"`` (streamed tensors: a tensor, or a callable that did not
        trace), ``"const"`` or ``"none"``."""
        return "stream" if self.coef_kind == "analytic" else self.coef_kind

    def __repr__(self):
        return f"TermSpec({self.kind}, {self.coef_kind})"


#: the advection-only stage: one WENO5 advection term with 3 streamed components
ADVECTION = TermSpec("advection", "stream", None, 3)


def n_components(kind: str) -> int:
    """Coefficient components of a term kind in 3D: 3 for advection, else 1."""
    return 3 if kind == "advection" else 1


def as_terms(terms):
    """A stage's term list as ``((TermSpec, streams), ...)``; three tensors
    (two on a 2D field) stand for one streamed advection term."""
    terms = tuple(terms)
    if len(terms) in (2, 3) and all(isinstance(x, torch.Tensor) for x in terms):
        return ((ADVECTION if len(terms) == 3 else TermSpec("advection", "stream", None, 2),
                 terms),)
    return tuple((spec, tuple(arrs)) for spec, arrs in terms)


def is_advection_only(terms) -> bool:
    """Whether a normalised term list is the advection-only stage (one
    advection term, streamed or a program), which keeps its own kernel
    entries and K3."""
    return len(terms) == 1 and terms[0][0].kind == "advection" and \
        terms[0][0].coef_kind in ("stream", "program")


def node_coords(shape, spacing, lo, dtype, device=None, origin=None):
    """Sparse node coordinates ``lo + (origin + i)*h`` per axis (``origin``
    in index units, default none): the coordinates the fused stage evaluates
    coefficient callables at (not ``Grid.coords``' linspace, which differs
    in the last bits)."""
    out = []
    for d, n in enumerate(shape):
        view = [1] * len(shape)
        view[d] = n
        i = torch.arange(n, dtype=dtype, device=device).reshape(view)
        if origin is not None:
            i = i + float(origin[d])
        out.append(lo[d] + i * float(spacing[d]))
    return tuple(out)


def program_values(spec: TermSpec, shape, spacing, lo, t, like: torch.Tensor, origin=None):
    """A program term's coefficient components at :func:`node_coords` and
    time ``t`` (a number, or a tensor whose graph the values keep), each
    broadcast to ``shape`` in ``like``'s dtype and device: the plain
    version of what K1″, K3″ and K6″ evaluate per node."""
    dtype, device = like.dtype, like.device
    xs = node_coords(shape, spacing, lo, dtype, device, origin)
    tt = (t.to(dtype=dtype, device=device) if isinstance(t, torch.Tensor)
          else torch.tensor(float(t), dtype=dtype, device=device))
    return tuple(torch.broadcast_to(torch.as_tensor(c, dtype=dtype, device=device), shape)
                 for c in spec.coef_static.evaluate(xs, tt))


def eval_components(value, shape, dtype, device, k=3) -> Tuple[torch.Tensor, ...]:
    """A coefficient as ``k`` contiguous tensors of ``shape`` (a scalar
    coefficient, ``k = 1``, may be one tensor or number)."""
    if isinstance(value, (tuple, list)):
        comps = value
    else:
        comps = [value] if k == 1 else [value[d] for d in range(k)]
    if len(comps) != k:
        raise ValueError(f"expected {k} coefficient components, got {len(comps)}")
    return tuple(
        torch.broadcast_to(torch.as_tensor(c, dtype=dtype, device=device), shape).contiguous()
        for c in comps)


def resolve_terms(terms, xs, t, shape, dtype, device, velocity=3):
    """The term list with every analytic coefficient evaluated at the
    coordinates ``xs`` and time ``t`` into streamed tensors of ``shape`` (an
    advection velocity of ``velocity`` components: 2 on the dense 2D
    stage)."""
    out = []
    for spec, arrs in terms:
        if spec.coef_kind == "analytic":
            k = velocity if spec.kind == "advection" else 1
            comps = eval_components(spec.coef_static(xs, t), shape, dtype, device, k)
            out.append((TermSpec(spec.kind, "stream", None, k), comps))
        else:
            out.append((spec, arrs))
    return tuple(out)


def _advection_ham(P, u, spacing, shape):
    """``sum_d u_d * WENO5_d(phi)`` on the interior of a padded buffer."""
    ham = 0.0
    for ax, h in enumerate(spacing):
        ham = ham + st.weno5_upwind(
            st.weno5_pair_diffs(P, ax, float(h), GHOST, shape), u[ax])
    return ham


def ham_contribution(spec: TermSpec, P, coef, center, spacing, shape):
    """One term's Hamiltonian on the interior of the padded buffer ``P``
    (counterpart of ``lsm_tpu.ops.weno_v2._ham_contribution``): ``coef`` the
    streamed tensors, ``(value,)`` for a constant, ``()`` for none;
    ``center`` the interior of ``P``."""
    spacing = tuple(float(h) for h in spacing)
    if spec.kind == "advection":
        return _advection_ham(P, coef, spacing, shape)
    if spec.kind == "normal":
        gp, gm = st.godunov_norms(P, spacing, GHOST, shape)
        v = coef[0]
        return st.pos(v) * gp + st.neg(v) * gm
    if spec.kind == "curvature":
        kap = geo.curvature_from_padded(P, spacing, GHOST, shape)
        nrm = geo.grad_norm_from_padded(P, spacing, GHOST, shape)
        return coef[0] * kap * nrm
    if spec.kind == "eikonal":
        gp, gm = st.godunov_norms(P, spacing, GHOST, shape)
        if spec.coef_kind == "none":
            # the sign recomputed from phi, with gradient-aware smoothing
            dx_min = min(spacing)
            norm = torch.where(torch.sign(center) > 0, gp, gm)
            denom = torch.sqrt(center ** 2 + norm ** 2 * dx_min * dx_min)
            s = torch.where(denom == 0, 0.0, center / torch.where(denom == 0, 1.0, denom))
        else:
            s = coef[0]
            norm = torch.where(torch.sign(s) > 0, gp, gm)
        return s * (norm - 1.0)
    raise ValueError(f"unknown term kind {spec.kind!r}")


class Where:
    """Where and when a stage evaluates its program terms: the grid's
    ``lo``, the ``origin`` offset of node 0 (index units, as JAX's), the
    stage time ``t`` (a number, or a 0-d tensor that the plain versions and
    the differentiable stages take the cotangent of) and ``value``, ``t`` as
    the host number the kernels take (given, a tensor ``t`` is not read
    back; default ``float(t)``)."""

    __slots__ = ("lo", "origin", "t", "_value")

    def __init__(self, lo=None, origin=None, t=0.0, value=None):
        self.lo = (0.0, 0.0, 0.0) if lo is None else tuple(float(x) for x in lo)
        self.origin = (0.0, 0.0, 0.0) if origin is None else tuple(float(o) for o in origin)
        self.t = t
        self._value = None if value is None else float(value)

    @property
    def value(self) -> float:
        if self._value is None:
            t = self.t
            self._value = float(t.detach()) if isinstance(t, torch.Tensor) else float(t)
        return self._value

    def at(self, t) -> "Where":
        """The same place at the time ``t`` (host number unchanged)."""
        return Where(self.lo, self.origin, t, self.value)


def embedding_2d(spacing, where: Optional[Where]):
    """``(spacing, where)`` of the ``(1, n0, n1)`` embedding of a 2D
    stage's ``spacing`` and ``where`` (its last two coordinates): the dummy
    axis takes the smallest spacing and coordinate 0, as JAX's embedding
    with the field's smallest spacing (see
    :func:`~lsm_tpu_torch.integrators.fused.embed_2d`). The 2D kernels' term
    table is built from these."""
    h = tuple(float(x) for x in spacing)
    w = where or Where()
    return (min(h), *h), Where((0.0, *w.lo[-2:]), (0.0, *w.origin[-2:]), w.t, w.value)


def program_values_at(spec: TermSpec, shape, spacing, where: Optional[Where],
                      like: torch.Tensor):
    """A program term's coefficient values on a grid of ``shape`` at
    ``where`` (its ``lo``, ``origin`` and time ``t``, whose graph a tensor
    keeps): :func:`program_values`; on a 2D ``shape`` the embedding's
    program at the embedding's nodes (:func:`embedding_2d`), 2D components,
    an advection velocity without the embedding's zero component 0."""
    where = where or Where()
    if len(shape) == 3:
        return program_values(spec, shape, spacing, where.lo, where.t, like, where.origin)
    spacing3, where3 = embedding_2d(spacing, where)
    vals = tuple(c[0] for c in program_values(spec, (1, *shape), spacing3, where3.lo, where3.t,
                                              like, where3.origin))
    return vals[1:] if spec.kind == "advection" else vals


def programs_2d(terms, shape, spacing, where: Optional[Where], like: torch.Tensor):
    """A 2D stage's term list with each program term (the embedding's, of
    the three embedding coordinates) evaluated at the embedding's nodes of
    ``shape`` into 2D streams (:func:`program_values_at`), its graph kept
    for a tensor ``where.t``. The other terms pass through. The plain 2D
    stage runs on this list."""
    out = []
    for spec, arrs in terms:
        if spec.coef_kind == "program":
            arrs = program_values_at(spec, shape, spacing, where, like)
            spec = TermSpec(spec.kind, "stream", None, len(arrs))
        out.append((spec, arrs))
    return tuple(out)


def _coef_values(spec: TermSpec, arrs, like: torch.Tensor, spacing=None, shape=None,
                 where: Optional[Where] = None):
    if spec.coef_kind == "stream":
        return tuple(arrs)
    if spec.coef_kind == "const":
        return (torch.full((), float(spec.coef_static), dtype=like.dtype, device=like.device),)
    if spec.coef_kind == "none":
        return ()
    if spec.coef_kind == "program":
        return program_values_at(spec, shape, spacing, where, like)
    raise ValueError(f"{spec!r}: evaluate an analytic coefficient first (resolve_terms)")


def _stage_interior(P, terms, coeffs, aux, spacing, shape, where: Optional[Where] = None):
    """``alpha*aux + beta*phi - gamma*sum_n H_n`` on the interior, with the
    arithmetic order of the JAX oracle; the coefficients are numbers or 0-d
    tensors, ``terms`` a normalised list without analytic coefficients
    (program terms are evaluated at ``where``; a 2D stage's by
    :func:`programs_2d`)."""
    alpha, beta, gamma = coeffs
    if len(shape) == 2:
        terms = programs_2d(terms, shape, spacing, where, P)
    center = st.shift(P, (0,) * len(shape), GHOST, shape)
    ham = 0.0
    for spec, arrs in terms:
        ham = ham + ham_contribution(spec, P, _coef_values(spec, arrs, P, spacing, shape, where),
                                     center, spacing, shape)
    res = beta * center - gamma * ham
    if aux is not None:
        res = alpha * unpack_padded(aux, shape) + res
    return res


def stage_plain(P, terms, coeffs, aux, spacing, shape, where: Optional[Where] = None
                ) -> torch.Tensor:
    """Plain version of K1: a fresh padded buffer holding the stage result in
    its interior; its ghost shells are left unset, as the kernel leaves them.
    ``terms`` as for :func:`fused_stage`; program terms evaluated at
    ``where``."""
    out = torch.empty_like(P)
    unpack_padded(out, shape).copy_(
        _stage_interior(P, as_terms(terms), coeffs, aux, spacing, shape, where))
    return out


def stage_reference(padded, term_specs_and_streams, coeffs, t, aux_padded, bcs,
                    spacing, shape, lo, origin=None) -> torch.Tensor:
    """Plain oracle on the padded layout; returns the INTERIOR. Ghosts are
    rebuilt from the interior and ``bcs`` (independent of the stored shells),
    and analytic and program coefficients are evaluated at
    :func:`node_coords` (shifted by ``origin``)."""
    shape = tuple(shape)
    full = pack_padded(unpack_padded(padded, shape), bcs)
    xs = node_coords(shape, spacing, lo, padded.dtype, padded.device, origin)
    terms = resolve_terms(as_terms(term_specs_and_streams), xs, t, shape, padded.dtype,
                          padded.device)
    return _stage_interior(full, terms, coeffs, aux_padded, spacing, shape,
                           Where(lo, origin, t))


def check_terms(terms, P, stream_shape, name="terms", velocity=3):
    """Validate a normalised term list for the kernels: known kinds, a
    coefficient kind each kind takes, streams of ``stream_shape`` like
    ``P`` (``velocity`` of them for a streamed advection term: 2 on the
    dense 2D stage), programs of the kind's component count, at most
    :data:`MAX_TERMS` entries."""
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"the stage kernels take 1 to {MAX_TERMS} terms, got {len(terms)}")
    for n, (spec, arrs) in enumerate(terms):
        if spec.kind not in KINDS:
            raise ValueError(f"unknown term kind {spec.kind!r}")
        allowed = _KERNEL_COEFS[spec.kind]
        if spec.coef_kind not in allowed:
            raise ValueError(
                f"term {n}: a {spec.kind} term with a {spec.coef_kind!r} coefficient is not a "
                f"kernel input (takes {allowed}); an analytic callable runs in-kernel once "
                "traced into a program (coef_program.trace), or is evaluated into streams "
                "first (resolve_terms)")
        if spec.coef_kind == "program" and (
                not isinstance(spec.coef_static, Program)
                or len(spec.coef_static.components) != n_components(spec.kind)):
            raise ValueError(f"term {n} ({spec.kind}) needs a Program of "
                             f"{n_components(spec.kind)} components")
        want = 0 if spec.coef_kind != "stream" else (
            velocity if spec.kind == "advection" else 1)
        if len(arrs) != want:
            raise ValueError(f"term {n} ({spec.kind}) needs {want} streams, got {len(arrs)}")
        for d, a in enumerate(arrs):
            _check(a, f"{name}[{n}] stream {d}", stream_shape, like=P)


class ProgramTable(ctypes.Structure):
    """The program terms' coordinates, time, ops and per-axis tables
    (``LsmProgram`` in ``csrc/lsm_kernels.h``): entry ``e``'s component
    ``d`` is ``len[e][d]`` ops from ``op[start[e][d]]``, each ``opcode |
    mode << 5 | operand << 8``; table slot ``s`` starts at ``tab_off[s]`` of
    the device buffer ``table`` and runs along axis ``tab_axis[s]``."""

    _fields_ = [("lo", ctypes.c_double * 3), ("h", ctypes.c_double * 3),
                ("origin", ctypes.c_double * 3), ("t", ctypes.c_double),
                ("start", (ctypes.c_int16 * 3) * MAX_TERMS),
                ("len", (ctypes.c_int16 * 3) * MAX_TERMS),
                ("op", ctypes.c_uint16 * _MAX_OPS), ("konst", ctypes.c_double * _MAX_CONSTS),
                ("table", ctypes.c_void_p), ("tab_dt", ctypes.c_int64),
                ("tab_off", ctypes.c_int32 * _MAX_TABLES),
                ("tab_axis", ctypes.c_int32 * _MAX_TABLES)]


class StageTerms(ctypes.Structure):
    """The kernels' term table and stage constants (``LsmStageTerms`` in
    ``csrc/lsm_kernels.h``), passed to K1, K3, K3' and K6 by value."""

    _fields_ = [("n", ctypes.c_int), ("kind", ctypes.c_int * MAX_TERMS),
                ("coef", ctypes.c_int * MAX_TERMS), ("value", ctypes.c_double * MAX_TERMS),
                ("stream", ctypes.c_void_p * (3 * MAX_TERMS))] + [
        (name, ctypes.c_double * 3)
        for name in ("inv_h", "half_h", "inv_two_h", "inv_hh", "inv_hmix")
    ] + [(name, ctypes.c_double) for name in ("dx_min", "alpha", "beta", "gamma")] + [
        ("prog", ProgramTable)]


class TableFill(ctypes.Structure):
    """The table programs of a stage (``LsmTableFill`` in
    ``csrc/lsm_kernels.h``): slot ``s`` runs ``nops[s]`` ops from
    ``prog.op[start[s]]`` at the ``count[s]`` indices of its axis into
    ``prog.table`` from ``prog.tab_off[s]``."""

    _fields_ = [("prog", ProgramTable), ("n", ctypes.c_int32), ("total", ctypes.c_int32),
                ("start", ctypes.c_int16 * _MAX_TABLES), ("nops", ctypes.c_int16 * _MAX_TABLES),
                ("count", ctypes.c_int32 * _MAX_TABLES)]


#: the mode bits of a binary op's immediate right operand, by leaf
_IMM_MODES = {"tab": 1, "const": 2, "tconst": 2, "x": 3, "t": 3}


def _encode(prog: ProgramTable, comp, at: int, k: int, slot0: int = 0):
    """Write the accumulator program ``comp`` into ``prog.op`` from ``at``,
    its constants into ``prog.konst`` from ``k``, its table slots offset by
    ``slot0``; returns the next ``(at, k)``."""
    for op, arg, mode in comp:
        if mode == "imm":  # a binary op whose right operand is a leaf
            leaf, leaf_arg = arg
            bits, operand = _IMM_MODES[leaf], 3 if leaf == "t" else leaf_arg
        else:
            bits, operand, leaf, leaf_arg = int(mode == "push"), 0, op, arg
        if leaf == "x":
            operand = leaf_arg
        elif leaf == "tab":
            operand = slot0 + leaf_arg
        elif leaf in ("const", "tconst", "powc"):
            prog.konst[k] = leaf_arg
            operand, k = k, k + 1
        prog.op[at] = OPCODES["const" if op == "tconst" else op] | (bits << 5) | (operand << 8)
        at += 1
    return at, k


def _set_where(prog: ProgramTable, spacing, where: Where):
    for d in range(3):
        prog.lo[d], prog.h[d], prog.origin[d] = where.lo[d], float(spacing[d]), where.origin[d]
    prog.t = where.value


def _table_layout(progs, shape):
    """``(axis, count, offset)`` of every table slot of ``progs`` in order,
    and their total."""
    out, at = [], 0
    for p in progs:
        for _, axis in p.tables:
            count = 1 if axis < 0 else int(shape[axis])
            out.append((axis, count, at))
            at += count
    return out, at


def table_fill(progs, shape, spacing, where: Where) -> TableFill:
    """The :class:`TableFill` of the tables of ``progs`` on a grid of
    ``shape`` at ``where`` (its buffer and ``tab_dt`` unset). The encoding
    is cached per programs, grid and place; only the time is set per call
    (the launch copies the struct)."""
    fill = _table_fill(tuple(progs), tuple(int(n) for n in shape),
                       tuple(float(h) for h in spacing), where.lo, where.origin)
    fill.prog.t = where.value
    return fill


@functools.lru_cache(maxsize=32)
def _table_fill(progs, shape, spacing, lo, origin) -> TableFill:
    layout, total = _table_layout(progs, shape)
    fill = TableFill()
    _set_where(fill.prog, spacing, Where(lo, origin))
    at = k = 0
    for s, (comp, (axis, count, off)) in enumerate(
            zip((c for p in progs for c in p.table_components), layout)):
        fill.start[s], fill.nops[s], fill.count[s] = at, len(comp), count
        fill.prog.tab_off[s], fill.prog.tab_axis[s] = off, axis
        at, k = _encode(fill.prog, comp, at, k)
    fill.n, fill.total = len(layout), total
    return fill


def program_tables_plain(progs, shape, spacing, where: Where, like: torch.Tensor,
                         need_dt: bool) -> torch.Tensor:
    """Plain version of :func:`program_tables`: every table of ``progs`` by
    :meth:`~.coef_program.Program.table_values` at ``where``'s node
    coordinates and time, then, with ``need_dt``, their t-derivatives
    (forward-mode autograd), in one buffer of ``like``'s dtype."""
    dtype, device = like.dtype, like.device
    xs = node_coords(shape, spacing, where.lo, dtype, device, where.origin)
    tt = torch.tensor(where.value, dtype=dtype, device=device)
    vals, tans = [], []
    for prog in progs:
        if need_dt:
            with fwAD.dual_level():
                out = [fwAD.unpack_dual(v) for v in prog.table_values(
                    xs, fwAD.make_dual(tt, torch.ones_like(tt)))]
            vals += [v.primal for v in out]
            tans += [torch.zeros_like(v.primal) if v.tangent is None else v.tangent
                     for v in out]
        else:
            vals += list(prog.table_values(xs, tt))
    parts = vals + tans
    return torch.cat(parts).contiguous() if parts else like.new_zeros(1)


def program_tables(progs, shape, spacing, where: Where, like: torch.Tensor,
                   need_dt: bool) -> torch.Tensor:
    """The per-axis tables of the programs ``progs`` at ``where``'s node
    coordinates and time, in one buffer of ``like``'s dtype and device laid
    out as :func:`_table_layout` says, with ``need_dt`` followed by their
    t-derivatives: what K1″, K3″ and K6″ read per node. CUDA tensors go to
    ``csrc/coef_tables.cu`` (the programs' interpreter, one thread per
    entry), CPU tensors to :func:`program_tables_plain`."""
    fill = table_fill(progs, shape, spacing, where)
    total = fill.total
    if like.device.type == "cpu" or total == 0:
        return program_tables_plain(progs, shape, spacing, where, like, need_dt)
    buf = like.new_empty(2 * total if need_dt else total)
    fill.prog.table, fill.prog.tab_dt = buf.data_ptr(), total if need_dt else 0
    lib = load_library()
    with torch.cuda.device(like.device):
        code = (lib.prog_tables_f32 if like.dtype == torch.float32 else lib.prog_tables_f64)(
            ctypes.addressof(fill), torch.cuda.current_stream().cuda_stream)
    _raise_on(code, lib, "program tables kernel")
    bump(program_tables, launches=1)
    return buf


program_tables.launches = 0


def _pack_programs(prog: ProgramTable, terms, spacing, where: Where, shape, like, need_dt):
    """Encode the program terms of ``terms`` into ``prog`` and fill their
    tables (:func:`program_tables`; the buffer is returned: it must live
    until the launch has run); raises ``ValueError`` when they do not fit
    the kernels' tables."""
    progs = [s.coef_static for s, _ in terms if s.coef_kind == "program"]
    n_ops, n_consts = sum(p.n_ops for p in progs), sum(p.n_consts for p in progs)
    n_tabs = sum(len(p.tables) for p in progs)
    t_ops, t_consts = (sum(p.n_table_ops for p in progs), sum(p.n_table_consts for p in progs))
    if (max(n_ops, t_ops) > _MAX_OPS or max(n_consts, t_consts) > _MAX_CONSTS
            or n_tabs > _MAX_TABLES):
        raise ValueError(f"the stage's programs take {n_ops} ops, {n_consts} constants and "
                         f"{n_tabs} tables (their programs {t_ops} ops and {t_consts} "
                         f"constants); the kernels' tables hold {_MAX_OPS}, {_MAX_CONSTS} "
                         f"and {_MAX_TABLES}")
    if shape is None or like is None:
        raise ValueError("a program term needs the stage's shape and a tensor of its dtype")
    _set_where(prog, spacing, where)
    layout, total = _table_layout(progs, shape)
    buf = program_tables(progs, shape, spacing, where, like, need_dt)
    prog.table, prog.tab_dt = buf.data_ptr(), total if need_dt else 0
    for s, (axis, _, off) in enumerate(layout):
        prog.tab_off[s], prog.tab_axis[s] = off, axis
    at = k = slot0 = 0
    for e, (spec, _) in enumerate(terms):
        if spec.coef_kind != "program":
            continue
        p = spec.coef_static
        for d, comp in enumerate(p.components):
            prog.start[e][d], prog.len[e][d] = at, len(comp)
            at, k = _encode(prog, comp, at, k, slot0)
        slot0 += len(p.tables)
    return buf


def stage_table(terms, spacing, coeffs, where: Optional[Where] = None, shape=None, like=None,
                need_dt: bool = False) -> StageTerms:
    """The :class:`StageTerms` of a checked term list. The spacing-derived
    constants are the reciprocals of what the plain version divides by
    (``h``, ``2h``, ``h*h``, ``4*h1*h2``), formed in float64; the kernel
    rounds each to its dtype and multiplies. Program terms are encoded with
    the coordinates and time of ``where``, their per-axis tables filled on
    ``like``'s device for a grid of ``shape`` (with their t-derivatives when
    ``need_dt``); the table keeps that buffer alive (``tab.tables``)."""
    tab = StageTerms()
    tab.n = len(terms)
    for n, (spec, arrs) in enumerate(terms):
        tab.kind[n] = _KIND_CODES[spec.kind]
        tab.coef[n] = _COEF_CODES[spec.coef_kind]
        tab.value[n] = float(spec.coef_static) if spec.coef_kind == "const" else 0.0
        for d, a in enumerate(arrs):
            tab.stream[3 * n + d] = a.data_ptr()
    h = [float(x) for x in spacing]
    for d in range(3):
        tab.inv_h[d], tab.half_h[d] = 1.0 / h[d], 0.5 * h[d]
        tab.inv_two_h[d], tab.inv_hh[d] = 1.0 / (2.0 * h[d]), 1.0 / (h[d] * h[d])
    for k, (i, j) in enumerate(((0, 1), (0, 2), (1, 2))):
        tab.inv_hmix[k] = 1.0 / (4.0 * h[i] * h[j])
    tab.dx_min = min(h)
    tab.alpha, tab.beta, tab.gamma = (float(c) for c in coeffs)
    tab.tables = None
    if any(spec.coef_kind == "program" for spec, _ in terms):
        tab.tables = _pack_programs(tab.prog, terms, spacing, where or Where(), shape, like,
                                    need_dt)
    return tab


def stage_route(terms, shape) -> str:
    """Which kernel of ``csrc/weno_stage.cu`` a stage of the normalised term
    list ``terms`` on a grid of ``shape`` launches on CUDA (a callable on
    the stream route counts as streamed). The launch chooses it from the
    table; this reports the same rule:

    - ``"K1 march"``: one streamed advection term;
    - ``"K1'' march"``: one advection term whose velocity is a program each
      of whose components reads axis 0 alone or not at all (evaluated per
      plane or per column);
    - ``"K1'' per node"``: the other advection programs, and every one on
      the 2D embedding (``shape[0] == 1``);
    - ``"K1' march R=3"`` / ``"K1' march R=2"``: any other list without a
      program coefficient, with an advection term (WENO5 reaches 3 nodes) or
      without (ENO2 and the curvature reach 2); on the embedding axis 0 is
      compiled out;
    - ``"K1' per node"``: a list with a program coefficient (its
      interpreter runs per node; in the march it measured slower);
    - on a 2D ``shape`` the 2D entries (``csrc/weno_stage_2d.cu``): ``"K1
      2D march"`` (one streamed advection term), ``"K1'' 2D march"`` (a
      velocity program each of whose components reads one axis or none:
      once per column or once per row), ``"K1'' 2D per node"`` (one that
      reads both) and ``"K1' 2D per node"`` (any other list), the last two
      one thread per node.
    """
    specs = [spec for spec, _ in terms]
    adv = any(spec.kind == "advection" for spec in specs)
    advection_only = len(specs) == 1 and specs[0].kind == "advection" and \
        specs[0].route in ("stream", "program")
    if len(shape) == 2:
        if not advection_only:
            return "K1' 2D per node"
        if specs[0].route == "stream":
            return "K1 2D march"
        per_node = any(a & 6 == 6 for a in specs[0].coef_static.axes[1:])
        return "K1'' 2D per node" if per_node else "K1'' 2D march"
    if advection_only:
        if specs[0].route == "stream":
            return "K1 march"
        per_node = shape[0] == 1 or any(a & 1 and a != 1 for a in specs[0].coef_static.axes)
        return "K1'' per node" if per_node else "K1'' march"
    if any(spec.coef_kind == "program" for spec in specs):
        return "K1' per node"
    return "K1' march R=3" if adv else "K1' march R=2"


def _checked_stage(P, terms, aux, spacing, shape):
    """``(terms, shape)`` of a fused stage's arguments, normalised and
    checked (``ValueError``/``TypeError`` on a mismatch)."""
    shape = tuple(shape)
    if len(shape) not in (2, 3) or len(spacing) != len(shape):
        raise ValueError("the fused stage takes a 3D or 2D shape and one spacing per axis")
    terms = tuple(terms)
    if all(isinstance(x, torch.Tensor) for x in terms) and len(terms) != len(shape):
        raise ValueError(f"the fused stage's velocity needs {len(shape)} components")
    terms = as_terms(terms)
    _check(P, "P", padded_shape(shape))
    check_terms(terms, P, shape, velocity=len(shape))
    if aux is not None:
        _check(aux, "aux", padded_shape(shape), like=P)
    return terms, shape


def fused_stage(P: torch.Tensor, terms, coeffs, aux: Optional[torch.Tensor],
                spacing, shape, where: Optional[Where] = None) -> torch.Tensor:
    """K1: one RK stage on the padded layout.

    ``out = alpha*aux + beta*phi - gamma*sum_n H_n`` in the interior of a
    fresh padded buffer; its ghost shells are stale until
    :func:`refresh_ghosts_fast`. ``terms`` is a list of ``(TermSpec,
    streams)`` (kinds advection, normal, curvature, eikonal; coefficients
    streamed, constant, none or a program; streams contiguous and
    interior-shaped), or three velocity tensors for the advection-only
    stage. ``aux`` a padded buffer or ``None``, ``coeffs`` ``(alpha, beta,
    gamma)`` as Python numbers (a new ``dt`` rebuilds nothing). A program
    term (K1″) is evaluated per node at ``lo + (origin + i)*h`` and the
    stage time of the :class:`Where` ``where`` (default: ``lo`` and
    ``origin`` zero, time 0).
    Replaces ``lsm_tpu.ops.weno_v2.fused_stage`` (a callable that did not
    trace is evaluated into streams first, :func:`resolve_terms`). CUDA
    tensors go to ``csrc/weno_stage.cu``, to the kernel :func:`stage_route`
    names; CPU tensors to :func:`stage_plain`. With ``shape[0] == 1`` (a 3D
    field of one plane) the marches (K1, K1′) and K1″'s per-node kernel
    compile axis 0 out and take every axis-0 difference as zero: ``P``'s
    axis-0 ghosts must copy its one plane, as :func:`pack_padded` and
    :func:`refresh_ghosts_fast` leave them under every boundary condition a
    one-node axis admits; on other ghosts the card drops a term that
    :func:`stage_plain` keeps (K1′'s per-node kernel, for a program
    coefficient, reads them).

    A 2D ``shape`` (``P`` of ``(n0+6, n1+6)``, ``spacing`` and ``where`` the
    field's) computes the function of JAX's ``(1, n0, n1)`` embedding, as
    the 2D band does: an advection term streams the field's two velocity
    components (or takes two tensors), a program is the embedding's (traced
    on the three embedding coordinates, the first the dummy axis at
    coordinate 0 and the field's smallest spacing, :func:`embedding_2d`).
    CUDA tensors go to ``csrc/weno_stage_2d.cu``, CPU tensors to the plain
    2D stage (:func:`programs_2d`, then the 2D stencils).
    """
    terms, shape = _checked_stage(P, terms, aux, spacing, shape)
    where = where or Where()
    if P.device.type == "cpu":
        return stage_plain(P, terms, coeffs, aux, spacing, shape, where)
    lib = load_library()
    f32 = P.dtype == torch.float32
    out = torch.empty_like(P)
    aux_ptr = None if aux is None else aux.data_ptr()
    ctx, stream = _on_card(P)
    with ctx:
        if len(shape) == 2:
            code = _stage_2d(lib, P, aux_ptr, out, terms, coeffs, spacing, shape, where, stream)
        elif is_advection_only(terms) and terms[0][0].coef_kind == "stream":
            u = terms[0][1]
            alpha, beta, gamma = (float(c) for c in coeffs)
            code = (lib.stage_f32 if f32 else lib.stage_f64)(
                P.data_ptr(), u[0].data_ptr(), u[1].data_ptr(), u[2].data_ptr(), aux_ptr,
                out.data_ptr(), *shape, *(1.0 / float(h) for h in spacing), alpha, beta, gamma,
                stream)
        else:
            tab = stage_table(terms, spacing, coeffs, where, shape, P)
            args = (P.data_ptr(), aux_ptr, out.data_ptr(), *shape, ctypes.addressof(tab))
            if is_advection_only(terms):  # the march reads which axes each component reads
                code = (lib.stage_prog_f32 if f32 else lib.stage_prog_f64)(
                    *args, *terms[0][0].coef_static.axes, stream)
            else:
                code = (lib.stage_terms_f32 if f32 else lib.stage_terms_f64)(*args, stream)
    _raise_on(code, lib, "weno_stage kernel")
    bump(fused_stage, launches=1, kinds_launches=not is_advection_only(terms),
         program_launches=any(spec.coef_kind == "program" for spec, _ in terms),
         launches_2d=len(shape) == 2)
    return out


fused_stage.launches = 0
fused_stage.kinds_launches = 0  # of the launches, those of the term-list entry
fused_stage.program_launches = 0  # of the launches, those with a program term (K1″)
fused_stage.launches_2d = 0  # of the launches, those of the 2D entries


def _table_2d(terms, coeffs, spacing, shape, where, P, need_dt=False) -> StageTerms:
    """The embedding's term table of a 2D stage (K1's 2D entries and the
    backward's, K3″ and K3' 2D; ``need_dt`` as for :func:`stage_table`): its
    spacing and coordinates (:func:`embedding_2d`), programs over ``(1, n0,
    n1)``; an advection term's component 0 (the embedding's zero, which the
    2D kernels never read) takes component 1's pointer."""
    spacing3, where3 = embedding_2d(spacing, where)
    terms3 = tuple((spec, (arrs[0], *arrs)) if spec.kind == "advection" and spec.coef_kind ==
                   "stream" else (spec, arrs) for spec, arrs in terms)
    return stage_table(terms3, spacing3, coeffs, where3, (1, *shape), P, need_dt)


def _stage_2d(lib, P, aux_ptr, out, terms, coeffs, spacing, shape, where, stream,
              per_node=False):
    """Launch K1's 2D entry for a checked term list; returns the CUDA error
    code. ``per_node`` takes the per-node form (the term-list entry, one
    thread per node) for any list, as :func:`fused_stage_2d_per_node`."""
    f32 = P.dtype == torch.float32
    if not per_node and is_advection_only(terms) and terms[0][0].coef_kind == "stream":
        u = terms[0][1]
        alpha, beta, gamma = (float(c) for c in coeffs)
        return (lib.stage_2d_f32 if f32 else lib.stage_2d_f64)(
            P.data_ptr(), u[0].data_ptr(), u[1].data_ptr(), aux_ptr, out.data_ptr(), *shape,
            *(1.0 / float(h) for h in spacing), alpha, beta, gamma, stream)
    tab = _table_2d(terms, coeffs, spacing, shape, where, P)
    args = (P.data_ptr(), aux_ptr, out.data_ptr(), *shape, ctypes.addressof(tab))
    if not per_node and is_advection_only(terms):  # the axes each component reads
        axes = terms[0][0].coef_static.axes
        return (lib.stage_prog_2d_f32 if f32 else lib.stage_prog_2d_f64)(
            *args, axes[1], axes[2], stream)
    return (lib.stage_terms_2d_f32 if f32 else lib.stage_terms_2d_f64)(*args, stream)


def fused_stage_2d_per_node(P: torch.Tensor, terms, coeffs, aux: Optional[torch.Tensor],
                            spacing, shape, where: Optional[Where] = None) -> torch.Tensor:
    """K1's 2D stage in its per-node form: one thread per node reading its
    stencils from device memory, K6's 2D function on the dense grid
    (``csrc/weno_stage_2d.cu`` ``stage_node_2d_kernel``), for any term list
    :func:`fused_stage` takes on a 2D ``shape``. :func:`fused_stage` takes
    this kernel for a term list (:func:`stage_route` "K1' 2D per node"); for
    the other entries it is the comparison beside their kernels. CUDA
    tensors only (the plain version is :func:`stage_plain`); counted in its
    own ``launches``."""
    if len(tuple(shape)) != 2 or P.device.type != "cuda":
        raise ValueError("the per-node 2D stage takes a 2D shape and CUDA tensors")
    terms, shape = _checked_stage(P, terms, aux, spacing, shape)
    lib = load_library()
    out = torch.empty_like(P)
    ctx, stream = _on_card(P)
    with ctx:
        code = _stage_2d(lib, P, None if aux is None else aux.data_ptr(), out, terms, coeffs,
                         spacing, shape, where or Where(), stream, per_node=True)
    _raise_on(code, lib, "weno_stage per-node 2D kernel")
    bump(fused_stage_2d_per_node, launches=1)
    return out


fused_stage_2d_per_node.launches = 0


# -- the differentiable stage --------------------------------------------------------


def stage_refresh_plain(P, terms, coeffs, aux, bcs, spacing, shape,
                        where: Optional[Where] = None) -> torch.Tensor:
    """Plain stage plus ghost refresh on the padded layout (counterpart of
    ``lsm_tpu.ops.weno_v2._stage_refresh_jnp``): the stage reads ``P``'s
    stored ghosts, as K1 does, and the result is packed with fresh ghosts.
    ``terms`` as for :func:`fused_stage`; ``coeffs`` and ``where.t`` may be
    tensors. Autograd through this function is the oracle of the stage's
    backward."""
    return pack_padded(_stage_interior(P, as_terms(terms), coeffs, aux, spacing, shape, where),
                       bcs)


def gradient_reason(terms) -> Optional[str]:
    """Why a gradient through a stage of ``terms`` (normalised; a callable
    coefficient counts as the streams the stepper evaluates it into) cannot
    run on CUDA; ``None`` for every list K1' takes, whose backward is K4, K3
    or K3' (K3″ for program terms), and K5."""
    if not 1 <= len(terms) <= MAX_TERMS:
        return f"the stage kernels take 1 to {MAX_TERMS} terms, got {len(terms)}"
    for spec, _ in terms:
        if spec.coef_kind not in _KERNEL_COEFS.get(spec.kind, ()) + ("analytic",):
            return f"{spec!r} is no input of the stage kernels"
    return None


def needs_t(terms) -> bool:
    """Whether a program term of ``terms`` depends on the stage time."""
    return any(spec.coef_kind == "program" and spec.coef_static.depends_on_t
               for spec, _ in terms)


def _unflatten(specs, counts, streams):
    """The term list of ``specs``, each taking its ``counts`` streams in turn."""
    it = iter(streams)
    return tuple((spec, tuple(next(it) for _ in range(k))) for spec, k in zip(specs, counts))


class _FusedStepStage(torch.autograd.Function):
    """K1 + K2 forward over a term list whose streams are the trailing
    arguments. Backward: K4 (fold the output cotangent's shells), K3 for one
    advection term or K3' for any other list (stage cotangents; K3″ for
    program terms, with the cotangent of the stage time ``t``), K5 (zero
    daux's shells); on the CPU their plain versions. Saves ``P``, ``aux`` and
    the streams (references, no copies). Without ``refresh`` (a static) the
    forward is K1 alone and the backward takes a cotangent whose shells the
    caller has already folded: no K4 (the sharded stages, whose refresh and
    its transpose span the mesh)."""

    @staticmethod
    def forward(ctx, P, aux, alpha, beta, gamma, t, statics, *streams):
        specs, counts, bcs, spacing, shape, values, where, refresh = statics
        out = fused_stage(P, _unflatten(specs, counts, streams), values, aux, spacing, shape,
                          where)
        if refresh:
            refresh_ghosts_fast(out, bcs, shape)
        ctx.save_for_backward(P, aux, *streams)
        ctx.statics = statics
        ctx.coef_like = tuple((c.dtype, c.device) if isinstance(c, torch.Tensor) else None
                              for c in (alpha, beta, gamma, t))
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from . import weno_v2_bwd as bwd  # imports this module

        P, aux, *streams = ctx.saved_tensors
        specs, counts, bcs, spacing, shape, values, where, refresh = ctx.statics
        terms = _unflatten(specs, counts, streams)
        need = ctx.needs_input_grad  # P, aux, alpha, beta, gamma, t, statics, *streams
        need_dt = need[5] and needs_t(terms)
        # K4 writes a new buffer and leaves g alone: autograd may hand this
        # node the caller's grad_outputs, or one buffer shared with another branch
        g = g.contiguous()
        gf = bwd.fold_ghost_cotangent_fast(g, bcs, shape) if refresh else g
        if is_advection_only(terms):
            spec, arrs = terms[0]
            dP, dstreams, dcoef, daux = bwd.stage_backward(
                P, arrs if spec.coef_kind == "stream" else spec.coef_static, values, aux, gf,
                spacing, shape, need_du=any(need[7:]), need_daux=need[1], where=where,
                need_dt=need_dt)
        else:
            dP, dstreams, dcoef, daux = bwd.stage_backward_terms(
                P, terms, values, aux, gf, spacing, shape,
                need_dstreams=any(need[7:]), need_daux=need[1], where=where, need_dt=need_dt)
        dstreams = dstreams or (None,) * len(streams)
        dc = tuple(None if like is None or not need[2 + k] or k >= len(dcoef) else
                   dcoef[k].to(dtype=like[0], device=like[1])
                   for k, like in enumerate(ctx.coef_like))
        return (dP if need[0] else None, daux if need[1] else None, *dc, None,
                *(d if n else None for d, n in zip(dstreams, need[7:])))


def fused_step_stage(P: torch.Tensor, terms, coeffs, aux, bcs, spacing, shape,
                     coeff_values=None, where: Optional[Where] = None,
                     refresh: bool = True) -> torch.Tensor:
    """One RK stage plus ghost refresh, differentiable (counterpart of
    ``lsm_tpu.ops.weno_v2.fused_step_stage``).

    The forward is :func:`fused_stage` (K1) then :func:`refresh_ghosts_fast`
    (K2); ``terms`` and ``where`` as for :func:`fused_stage`. ``coeffs =
    (alpha, beta, gamma)`` and ``where.t`` are numbers or 0-d tensors. The
    kernels take them as host numbers: ``coeff_values`` and ``where.value``
    give them, so a tensor is not read back here (default: ``float`` of
    each). When nothing needs a gradient, the call is K1 + K2 and keeps
    nothing for a backward. Otherwise gradients flow to ``P``, the streams,
    ``aux``, the tensor coefficients and, through a program term that
    depends on it, ``where.t``: through K4, then K3 for one advection term
    or K3' for any other term list (K3″ evaluates the programs, the time's
    cotangent included), then K5. ``refresh=False`` leaves the ghost shells
    to the caller: the forward is K1 alone, and the backward takes the
    output's cotangent as already folded (no K4).

    A 2D stage (``shape`` of two entries, K1's and K2's 2D entries) takes
    the same route: its backward is the 2D entries of K4, K3 or K3' and K5
    (on the CPU their plain versions on the 2D stencils).
    """
    shape = tuple(shape)
    terms = tuple(terms)
    if all(isinstance(x, torch.Tensor) for x in terms) and len(terms) != len(shape):
        raise ValueError(f"the fused stage's velocity needs {len(shape)} components")
    terms = as_terms(terms)
    values = tuple(float(c.detach()) if isinstance(c, torch.Tensor) else float(c)
                   for c in (coeffs if coeff_values is None else coeff_values))
    where = where or Where()
    t = where.t if needs_t(terms) else None
    streams = [a for _, arrs in terms for a in arrs]
    tensors = [P, *streams, aux, *coeffs, t]
    if not (torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors)):
        out = fused_stage(P, terms, values, aux, spacing, shape, where)
        return refresh_ghosts_fast(out, bcs, shape) if refresh else out
    statics = (tuple(spec for spec, _ in terms), tuple(len(arrs) for _, arrs in terms), bcs,
               tuple(spacing), shape, values, where.at(where.value), refresh)
    return _FusedStepStage.apply(P, aux, *coeffs, t, statics, *streams)
