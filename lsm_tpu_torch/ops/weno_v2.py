"""Persistent padded layout and the two kernels of the fused 3D advection path
(port of :mod:`lsm_tpu.ops.weno_v2`).

Layout: the level set lives in one ``(n0+6, n1+6, n2+6)`` buffer with 3 ghost
layers on every axis (WENO5's reach). The TPU layout's 8-row sublane pad, its
lane-roll view and its ``n2 % 128`` rule are TPU constraints and are not kept:
every shell is stored, so a stage kernel reads plain neighbours.

Kernels, each beside its plain torch version (used for CPU tensors, by the
tests and by the on-card comparison in ``chip_smoke.py``):

- :func:`fused_stage` (K1, ``csrc/weno_stage.cu``; plain :func:`stage_plain`)
  writes ``alpha*aux + beta*phi - gamma*u.grad(phi)`` (WENO5 upwind) into the
  interior of a fresh padded buffer, ghost shells left stale.
- :func:`refresh_ghosts_fast` (K2, ``csrc/refresh_ghosts.cu``; plain
  :func:`refresh_ghosts_plain`) rewrites the ghost shells in place from the
  interior: axis 0, then axis 1, then axis 2, so corner ghosts equal
  ``pad_ghost(values, bcs, 3)``.
- :func:`fused_step_stage` is K1 + K2 as a ``torch.autograd.Function``
  whose backward runs K4, K3 and K5 (:mod:`.weno_v2_bwd`); its plain
  counterpart is :func:`stage_refresh_plain`.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises. Each counts its kernel launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..core import bc as _bc
from . import stencils as st
from ._build import load_library

__all__ = [
    "GHOST",
    "padded_shape",
    "pack_padded",
    "unpack_padded",
    "refresh_ghosts",
    "refresh_axis_plain",
    "refresh_ghosts_plain",
    "refresh_ghosts_fast",
    "node_coords",
    "stage_plain",
    "stage_reference",
    "fused_stage",
    "stage_refresh_plain",
    "fused_step_stage",
    "TermSpec",
]

GHOST = st.PAD_WENO5  # 3 ghost layers on every axis
_MAX_DEGREE = 7  # K2 takes Lagrange extrapolation up to this degree
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
    ghost at distance ``k``, computed in float64 on the host."""
    kinds = (ctypes.c_int * 6)()
    degrees = (ctypes.c_int * 6)()
    weights = (ctypes.c_double * (6 * GHOST * (_MAX_DEGREE + 1)))()
    for ax, n in enumerate(shape):
        if n < GHOST + 1:
            raise ValueError(f"axis {ax} has {n} nodes; the ghost refresh needs >= {GHOST + 1}")
        for side in range(2):
            b = bcs[ax][side]
            code = _BC_CODES.get(type(b))
            if code is None:
                raise TypeError(f"unsupported boundary condition {b!r}")
            kinds[2 * ax + side] = code
            if code == 2:
                P = b.degree
                if P > _MAX_DEGREE or P + 1 > n:
                    raise ValueError(
                        f"Extrapolation({P}) on axis {ax} with {n} nodes: the ghost "
                        f"refresh takes degree <= {_MAX_DEGREE} and degree + 1 <= n")
                degrees[2 * ax + side] = P
                W = _bc._lagrange_extrap_weights(GHOST, P)  # row g <-> k = 3 - g
                for k in range(1, GHOST + 1):
                    base = ((2 * ax + side) * GHOST + (k - 1)) * (_MAX_DEGREE + 1)
                    for j in range(P + 1):
                        weights[base + j] = float(W[GHOST - k, j])
    return kinds, degrees, weights


def refresh_ghosts_fast(padded: torch.Tensor, bcs, shape) -> torch.Tensor:
    """K2: refresh the ghost shells of a padded 3D buffer in place.

    Replaces ``lsm_tpu.ops.weno_v2.refresh_ghosts_fast``. CUDA tensors go to
    ``csrc/refresh_ghosts.cu`` (three launches: axis 0, 1, 2), CPU tensors to
    :func:`refresh_ghosts_plain`. Returns ``padded``.
    """
    shape = tuple(shape)
    if len(shape) != 3:
        raise ValueError(f"the ghost refresh is 3D only, got shape {shape}")
    _check(padded, "padded", padded_shape(shape))
    kinds, degrees, weights = _ghost_args(bcs, shape)
    if padded.device.type == "cpu":
        return refresh_ghosts_plain(padded, bcs, shape)
    lib = load_library()
    fn = lib.refresh_f32 if padded.dtype == torch.float32 else lib.refresh_f64
    with torch.cuda.device(padded.device):
        code = fn(padded.data_ptr(), *shape, ctypes.addressof(kinds),
                  ctypes.addressof(degrees), ctypes.addressof(weights),
                  torch.cuda.current_stream().cuda_stream)
    _raise_on(code, lib, "refresh_ghosts kernel")
    refresh_ghosts_fast.launches += 1
    return padded


refresh_ghosts_fast.launches = 0


# -- K1: fused RK stage -------------------------------------------------------------


class TermSpec:
    """Description of one fused term: ``kind`` (``"advection"`` in this port)
    and ``coef_kind``, one of ``("stream", n)`` — ``n`` coefficient tensors —
    or ``("analytic", fn)`` — a coordinate callable ``fn(xs, t)`` that the
    stepper evaluates into streamed tensors at each stage time."""

    __slots__ = ("kind", "coef_kind", "coef_static", "n_streams")

    def __init__(self, kind, coef_kind, coef_static=None, n_streams=0):
        self.kind = kind
        self.coef_kind = coef_kind
        self.coef_static = coef_static
        self.n_streams = n_streams

    def __repr__(self):
        return f"TermSpec({self.kind}, {self.coef_kind})"


def node_coords(shape, spacing, lo, dtype, device=None):
    """Sparse node coordinates ``lo + i*h`` per axis: the coordinates the
    fused stage evaluates coefficient callables at (not ``Grid.coords``'
    linspace, which differs in the last bits)."""
    out = []
    for d, n in enumerate(shape):
        view = [1] * len(shape)
        view[d] = n
        i = torch.arange(n, dtype=dtype, device=device).reshape(view)
        out.append(lo[d] + i * float(spacing[d]))
    return tuple(out)


def eval_components(value, shape, dtype, device, k=3) -> Tuple[torch.Tensor, ...]:
    """A coefficient as ``k`` contiguous interior-shaped tensors."""
    comps = value if isinstance(value, (tuple, list)) else [value[d] for d in range(k)]
    if len(comps) != k:
        raise ValueError(f"expected {k} velocity components, got {len(comps)}")
    return tuple(
        torch.broadcast_to(torch.as_tensor(c, dtype=dtype, device=device), shape).contiguous()
        for c in comps)


def _advection_ham(P, u, spacing, shape):
    """``sum_d u_d * WENO5_d(phi)`` on the interior of a padded buffer."""
    ham = 0.0
    for ax, h in enumerate(spacing):
        ham = ham + st.weno5_upwind(
            st.weno5_pair_diffs(P, ax, float(h), GHOST, shape), u[ax])
    return ham


def _advection_interior(P, u, coeffs, aux, spacing, shape):
    """``alpha*aux + beta*phi - gamma*H`` on the interior, with the
    arithmetic order of the JAX oracle; the coefficients are numbers or
    0-d tensors."""
    alpha, beta, gamma = coeffs
    center = st.shift(P, (0,) * len(shape), GHOST, shape)
    res = beta * center - gamma * _advection_ham(P, u, spacing, shape)
    if aux is not None:
        res = alpha * unpack_padded(aux, shape) + res
    return res


def stage_plain(P, u, coeffs, aux, spacing, shape) -> torch.Tensor:
    """Plain version of K1: a fresh padded buffer holding the stage result in
    its interior; its ghost shells are left unset, as the kernel leaves them."""
    out = torch.empty_like(P)
    unpack_padded(out, shape).copy_(_advection_interior(P, u, coeffs, aux, spacing, shape))
    return out


def stage_reference(padded, term_specs_and_streams, coeffs, t, aux_padded, bcs,
                    spacing, shape, lo) -> torch.Tensor:
    """Plain oracle on the padded layout; returns the INTERIOR. Ghosts are
    rebuilt from the interior and ``bcs`` (independent of the stored shells),
    and analytic coefficients are evaluated at :func:`node_coords`."""
    shape = tuple(shape)
    full = pack_padded(unpack_padded(padded, shape), bcs)
    out = None
    for spec, arrs in term_specs_and_streams:
        if spec.kind != "advection":
            raise NotImplementedError(
                f"term kind {spec.kind!r}: only advection is ported "
                "(ROADMAP.md queue 2, K1 term kinds)")
        if spec.coef_kind == "analytic":
            xs = node_coords(shape, spacing, lo, padded.dtype, padded.device)
            u = eval_components(spec.coef_static(xs, t), shape, padded.dtype, padded.device)
        else:
            u = tuple(arrs)
        term = _advection_ham(full, u, spacing, shape)
        out = term if out is None else out + term
    alpha, beta, gamma = coeffs
    res = beta * unpack_padded(full, shape) - gamma * out
    if aux_padded is not None:
        res = alpha * unpack_padded(aux_padded, shape) + res
    return res


def fused_stage(P: torch.Tensor, u: Sequence[torch.Tensor], coeffs, aux: Optional[torch.Tensor],
                spacing, shape) -> torch.Tensor:
    """K1: one RK stage of WENO5 advection on the padded layout.

    ``out = alpha*aux + beta*phi - gamma*sum_d u_d * dphi/dx_d`` (upwind
    WENO5) in the interior of a fresh padded buffer; its ghost shells are
    stale until :func:`refresh_ghosts_fast`. ``u`` is three contiguous
    interior-shaped tensors, ``aux`` a padded buffer or ``None``, ``coeffs``
    ``(alpha, beta, gamma)`` as Python numbers (a new ``dt`` rebuilds
    nothing). Replaces ``lsm_tpu.ops.weno_v2.fused_stage`` for the advection
    kind with streamed velocity. CUDA tensors go to ``csrc/weno_stage.cu``,
    CPU tensors to :func:`stage_plain`.
    """
    shape = tuple(shape)
    if len(shape) != 3 or len(u) != 3 or len(spacing) != 3:
        raise ValueError("the fused stage is 3D only: shape, u and spacing need 3 entries")
    _check(P, "P", padded_shape(shape))
    for d, ud in enumerate(u):
        _check(ud, f"u[{d}]", shape, like=P)
    if aux is not None:
        _check(aux, "aux", padded_shape(shape), like=P)
    if P.device.type == "cpu":
        return stage_plain(P, u, coeffs, aux, spacing, shape)
    lib = load_library()
    fn = lib.stage_f32 if P.dtype == torch.float32 else lib.stage_f64
    out = torch.empty_like(P)
    alpha, beta, gamma = (float(c) for c in coeffs)
    with torch.cuda.device(P.device):
        code = fn(P.data_ptr(), u[0].data_ptr(), u[1].data_ptr(), u[2].data_ptr(),
                  None if aux is None else aux.data_ptr(), out.data_ptr(), *shape,
                  *(1.0 / float(h) for h in spacing), alpha, beta, gamma,
                  torch.cuda.current_stream().cuda_stream)
    _raise_on(code, lib, "weno_stage kernel")
    fused_stage.launches += 1
    return out


fused_stage.launches = 0


# -- the differentiable stage --------------------------------------------------------


def stage_refresh_plain(P, u, coeffs, aux, bcs, spacing, shape) -> torch.Tensor:
    """Plain stage plus ghost refresh on the padded layout (counterpart of
    ``lsm_tpu.ops.weno_v2._stage_refresh_jnp``): the stage reads ``P``'s
    stored ghosts, as K1 does, and the result is packed with fresh ghosts.
    ``coeffs`` may be tensors; autograd through this function is the oracle
    of the stage's backward."""
    return pack_padded(_advection_interior(P, u, coeffs, aux, spacing, shape), bcs)


class _FusedStepStage(torch.autograd.Function):
    """K1 + K2 forward; backward K4 (fold the output cotangent's shells),
    K3 (stage cotangents), K5 (zero daux's shells). Saves ``P``, the
    streams and ``aux`` (references, no copies)."""

    @staticmethod
    def forward(ctx, P, u0, u1, u2, aux, alpha, beta, gamma, statics):
        bcs, spacing, shape, values = statics
        out = fused_stage(P, (u0, u1, u2), values, aux, spacing, shape)
        refresh_ghosts_fast(out, bcs, shape)
        ctx.save_for_backward(P, u0, u1, u2, aux)
        ctx.statics = statics
        ctx.coef_like = tuple((c.dtype, c.device) if isinstance(c, torch.Tensor) else None
                              for c in (alpha, beta, gamma))
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from . import weno_v2_bwd as bwd  # imports this module

        P, u0, u1, u2, aux = ctx.saved_tensors
        bcs, spacing, shape, values = ctx.statics
        need = ctx.needs_input_grad
        # K4 folds in place, so it gets a copy: autograd may hand this node
        # the caller's grad_outputs, or one buffer shared with another branch
        g = bwd.fold_ghost_cotangent_fast(g.clone(memory_format=torch.contiguous_format),
                                          bcs, shape)
        dP, du, dcoef, daux = bwd.stage_backward(
            P, (u0, u1, u2), values, aux, g, spacing, shape,
            need_du=any(need[1:4]), need_daux=need[4])
        du = du or (None,) * 3
        dc = tuple(None if like is None or not need[5 + k] else
                   dcoef[k].to(dtype=like[0], device=like[1])
                   for k, like in enumerate(ctx.coef_like))
        return (dP if need[0] else None, *(d if n else None for d, n in zip(du, need[1:4])),
                daux, *dc, None)


def fused_step_stage(P: torch.Tensor, u: Sequence[torch.Tensor], coeffs, aux, bcs, spacing,
                     shape, coeff_values=None) -> torch.Tensor:
    """One RK stage plus ghost refresh, differentiable (counterpart of
    ``lsm_tpu.ops.weno_v2.fused_step_stage``).

    The forward is :func:`fused_stage` (K1) then :func:`refresh_ghosts_fast`
    (K2). ``coeffs = (alpha, beta, gamma)`` are numbers or 0-d tensors;
    gradients flow to ``P``, the three streams ``u``, ``aux`` and the tensor
    coefficients through K4, K3 and K5. The kernels take the coefficients as
    host numbers: ``coeff_values`` gives them, so a tensor coefficient is not
    read back here (default: ``float`` of each coefficient). When nothing
    needs a gradient, the call is K1 + K2 and keeps nothing for a backward.
    """
    shape = tuple(shape)
    values = tuple(float(c) for c in (coeffs if coeff_values is None else coeff_values))
    tensors = [P, *u, aux, *coeffs]
    if not (torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)):
        out = fused_stage(P, u, values, aux, spacing, shape)
        return refresh_ghosts_fast(out, bcs, shape)
    if len(u) != 3:
        raise ValueError("the fused stage is 3D only: u needs 3 entries")
    return _FusedStepStage.apply(P, *u, aux, *coeffs,
                                 (bcs, tuple(spacing), shape, values))
