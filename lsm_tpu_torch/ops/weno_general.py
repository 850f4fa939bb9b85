"""The WENO5 advection stage of the general path (port of
:mod:`lsm_tpu.ops.weno_pallas`).

The general path is every step that does not go through a fused stepper:
``integrate`` with hooks or ``fast="off"``, a term list the steppers do not
take, ``rollout(fast="off")``. There ``AdvectionTerm`` pads the field by 3
on every side (``MeshField.pad(3)``) and computes, with ``u``, ``aux`` and
the result interior-shaped,

    alpha*aux + beta*phi - gamma * sum_d u_d * WENO5_d(phi)

(``coeffs=None``: the bare Hamiltonian). Kernels, each beside its plain
torch version:

- K10 (3D) and K11 (2D), ``csrc/weno_general.cu``: :func:`weno_stage_3d`
  and :func:`weno_stage_2d`, chosen by :func:`weno_stage_general`; plain
  :func:`_stage_plain` and :func:`_weno_hamiltonian_plain`.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises, for every shape (the JAX package's fallback
to jnp where no tile divides the shape has no counterpart). Each counts its
launches in ``launches``.

:func:`weno_advection_rhs` and :func:`weno_advection_stage` are the
differentiable entries (``torch.autograd.Function``): forward the kernel (or
the plain version on the CPU), backward the VJP of the plain composite
recomputed from the saved inputs, as JAX's custom VJP does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import stencils as st
from ._build import load_library
from ._launches import bump
from .weno_v2 import _check, _on_card, _raise_on

__all__ = [
    "GHOST",
    "weno_stage_general",
    "weno_stage_3d",
    "weno_stage_2d",
    "weno_hamiltonian",
    "weno_advection_rhs",
    "weno_advection_stage",
]

GHOST = st.PAD_WENO5  # the padded field's ghost layers on every side
_BARE = (0.0, 0.0, -1.0)  # (alpha, beta, gamma) of the bare Hamiltonian


def _weno_hamiltonian_plain(padded, u, spacing, shape) -> torch.Tensor:
    """``sum_d u_d * WENO5_d(phi)`` on the interior of ``padded``."""
    out = 0.0
    for ax, h in enumerate(spacing):
        out = out + st.weno5_upwind(st.weno5_pair_diffs(padded, ax, h, GHOST, shape), u[ax])
    return out


def _stage_plain(padded, u, aux, coeffs, spacing, shape) -> torch.Tensor:
    """Plain version of K10/K11, in JAX's ``_stage_jnp`` order; the
    coefficients are numbers or 0-d tensors."""
    ham = _weno_hamiltonian_plain(padded, u, spacing, shape)
    center = st.shift(padded, (0,) * len(shape), GHOST, shape)
    out = coeffs[1] * center - coeffs[2] * ham
    if aux is not None:
        out = coeffs[0] * aux + out
    return out


def _run(name, ndim, padded, u, spacing, shape, coeffs, aux):
    """Check the arguments, then the plain version (CPU tensors) or the
    library's ``{name}_f32/f64`` kernel (CUDA tensors): ``(out, launched)``."""
    shape = tuple(shape)
    if len(shape) != ndim or len(u) != ndim:
        raise ValueError(f"the {ndim}D stage takes a {ndim}D shape and {ndim} velocity "
                         f"components, got shape {shape} and {len(u)} components")
    _check(padded, "padded", tuple(n + 2 * GHOST for n in shape))
    for d, c in enumerate(u):
        _check(c, f"u[{d}]", shape, like=padded)
    if aux is not None:
        _check(aux, "aux", shape, like=padded)
    coeffs = _BARE if coeffs is None else coeffs
    if padded.device.type == "cpu":
        return _stage_plain(padded, u, aux, coeffs, spacing, shape), 0
    lib = load_library()
    fn = getattr(lib, f"{name}_{'f32' if padded.dtype == torch.float32 else 'f64'}")
    out = torch.empty(shape, dtype=padded.dtype, device=padded.device)
    ctx, stream = _on_card(padded)
    with ctx:
        code = fn(padded.data_ptr(), *(c.data_ptr() for c in u),
                  None if aux is None else aux.data_ptr(), out.data_ptr(), *shape,
                  *(1.0 / float(h) for h in spacing), *(float(c) for c in coeffs), stream)
    _raise_on(code, lib, f"{name} kernel")
    return out, 1


def weno_stage_3d(padded, u, spacing, shape, coeffs=None, aux=None) -> torch.Tensor:
    """K10: the 3D stage (see :func:`weno_stage_general`). Replaces
    ``lsm_tpu.ops.weno_pallas.weno_stage_pallas`` in 3D (``_make_kernel_3d``)."""
    out, launched = _run("general_3d", 3, padded, u, spacing, shape, coeffs, aux)
    bump(weno_stage_3d, launches=launched)
    return out


weno_stage_3d.launches = 0


def weno_stage_2d(padded, u, spacing, shape, coeffs=None, aux=None) -> torch.Tensor:
    """K11: the 2D stage (see :func:`weno_stage_general`). Replaces
    ``lsm_tpu.ops.weno_pallas.weno_stage_pallas`` in 2D (``_make_kernel_2d``)."""
    out, launched = _run("general_2d", 2, padded, u, spacing, shape, coeffs, aux)
    bump(weno_stage_2d, launches=launched)
    return out


weno_stage_2d.launches = 0


def weno_stage_general(padded: torch.Tensor, u: Sequence[torch.Tensor], spacing, shape,
                       coeffs=None, aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha*aux + beta*phi - gamma*H`` on a field padded by 3 on every side
    (counterpart of ``lsm_tpu.ops.weno_pallas.weno_stage_pallas``): ``u`` the
    per-axis velocity, ``aux`` (or ``None``) and the result interior-shaped
    and contiguous, ``coeffs = (alpha, beta, gamma)`` numbers; ``None``
    gives the bare Hamiltonian ``H = sum_d u_d * WENO5_d(phi)``. 3D goes to
    K10, 2D to K11 (CUDA tensors), or to the plain version (CPU tensors)."""
    if len(tuple(shape)) == 2:
        return weno_stage_2d(padded, u, spacing, shape, coeffs, aux)
    if len(tuple(shape)) == 3:
        return weno_stage_3d(padded, u, spacing, shape, coeffs, aux)
    raise ValueError(f"the WENO5 stage takes 2D and 3D fields, got shape {tuple(shape)}")


def weno_hamiltonian(padded, u, spacing, shape) -> torch.Tensor:
    """The bare WENO5 advection Hamiltonian (counterpart of
    ``lsm_tpu.ops.weno_pallas.weno_hamiltonian_pallas``)."""
    return weno_stage_general(padded, u, spacing, shape, None, None)


# -- the differentiable entries -------------------------------------------------------


def _components(u, shape, like: torch.Tensor):
    """Velocity components as contiguous tensors of ``shape`` in ``like``'s
    dtype and device (a broadcast callable value is materialized);
    differentiable."""
    return tuple(torch.broadcast_to(torch.as_tensor(c, dtype=like.dtype, device=like.device),
                                    tuple(shape)).contiguous() for c in u)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _leaf(x, need):
    return x.detach().requires_grad_() if need else x


def _vjp(fn, args, need, g):
    """Cotangents of ``fn(*args)`` for the arguments flagged in ``need``
    (``None`` elsewhere), by autograd of ``fn`` recomputed from ``args``."""
    with torch.enable_grad():
        leaves = [_leaf(a, n and isinstance(a, torch.Tensor)) for a, n in zip(args, need)]
        wanted = [x for x, n in zip(leaves, need) if n and isinstance(x, torch.Tensor)]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, g, allow_unused=True)
                     if wanted else ())
    return [next(grads) if n and isinstance(a, torch.Tensor) else None
            for a, n in zip(args, need)]


class _Rhs(torch.autograd.Function):
    """Forward K10/K11 (plain on the CPU); backward the VJP of
    :func:`_weno_hamiltonian_plain` (JAX's ``_rhs_bwd``)."""

    @staticmethod
    def forward(ctx, padded, statics, *u):
        spacing, shape = statics
        ctx.save_for_backward(padded, *u)
        ctx.statics = statics
        return weno_hamiltonian(padded, u, spacing, shape)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        padded, *u = ctx.saved_tensors
        spacing, shape = ctx.statics
        need = ctx.needs_input_grad  # padded, statics, *u
        grads = _vjp(lambda p, *uu: _weno_hamiltonian_plain(p, uu, spacing, shape),
                     (padded, *u), (need[0], *need[2:]), g)
        return grads[0], None, *grads[1:]


class _Stage(torch.autograd.Function):
    """Forward K10/K11 (plain on the CPU) with the coefficients' host values;
    backward the VJP of :func:`_stage_plain` (JAX's ``_stage_bwd``), with
    cotangents for ``padded``, ``aux``, the tensor coefficients and ``u``."""

    @staticmethod
    def forward(ctx, padded, aux, alpha, beta, gamma, statics, *u):
        spacing, shape, values = statics
        ctx.save_for_backward(padded, aux, *u)
        ctx.statics = statics
        ctx.coef_like = tuple((c.dtype, c.device) if isinstance(c, torch.Tensor) else None
                              for c in (alpha, beta, gamma))
        return weno_stage_general(padded, u, spacing, shape, values, aux)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        padded, aux, *u = ctx.saved_tensors
        spacing, shape, values = ctx.statics
        need = ctx.needs_input_grad  # padded, aux, alpha, beta, gamma, statics, *u
        coefs = tuple(torch.tensor(v, dtype=g.dtype, device=g.device) if like else v
                      for v, like in zip(values, ctx.coef_like))
        grads = _vjp(lambda p, a, ca, cb, cg, *uu: _stage_plain(p, uu, a, (ca, cb, cg),
                                                                spacing, shape),
                     (padded, aux, *coefs, *u), (*need[:5], *need[6:]), g)
        dcoef = tuple(None if d is None else d.to(dtype=like[0], device=like[1])
                      for d, like in zip(grads[2:5], ctx.coef_like))
        return grads[0], grads[1], *dcoef, None, *grads[5:]


def weno_advection_rhs(padded, u, spacing, shape) -> torch.Tensor:
    """The WENO5 advection Hamiltonian on a padded field, differentiable
    (counterpart of ``lsm_tpu.ops.weno_pallas.weno_advection_rhs``). The
    components of ``u`` may be anything that broadcasts to ``shape``."""
    shape = tuple(shape)
    u = _components(u, shape, padded)
    if not _needs_grad(padded, *u):
        return weno_hamiltonian(padded, u, spacing, shape)
    return _Rhs.apply(padded, (tuple(spacing), shape), *u)


def weno_advection_stage(padded, u, aux, coeffs, spacing, shape,
                         coeff_values=None) -> torch.Tensor:
    """The RK stage ``alpha*aux + beta*phi - gamma*H``, differentiable
    (counterpart of ``lsm_tpu.ops.weno_pallas.weno_advection_stage``).
    ``coeffs`` are numbers or 0-d tensors; the kernel takes them as host
    numbers, ``coeff_values`` (default ``float`` of each), so a tensor
    coefficient such as ``rollout``'s ``dt`` is not read back here. Gradients
    flow to ``padded``, ``u``, ``aux`` and the tensor coefficients."""
    shape = tuple(shape)
    u = _components(u, shape, padded)
    values = tuple(float(c.detach()) if isinstance(c, torch.Tensor) else float(c)
                   for c in (coeffs if coeff_values is None else coeff_values))
    if aux is not None:
        aux = aux.contiguous()
    if not _needs_grad(padded, aux, *coeffs, *u):
        return weno_stage_general(padded, u, spacing, shape, values, aux)
    return _Stage.apply(padded, aux, *coeffs, (tuple(spacing), shape, values), *u)
