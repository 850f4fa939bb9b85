"""In-kernel analytic coefficients (K1″, K3″, K6″) and ``update_func`` on the
fused stepper, against the JAX package on the CPU in float64: the program
route's stage (the advection-only and the term-list entry, with and without
aux, at a nonzero origin) against JAX's stage oracle and its Pallas stage in
interpret mode, ``integrate`` and ``rollout`` (with ``t0``/``dt``
gradients) with a callable, the band stage with a program velocity, and the
dense stepper's ``update_func`` path against JAX's fused one. On CPU tensors
the wrappers run their plain versions, which evaluate the traced program.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.models import shapes as jshapes
from lsm_tpu.ops import band_pallas as bp
from lsm_tpu.ops import weno_v2 as jv2
from lsm_tpu_torch.integrators import band_fused as tband
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import coef_program as cp
from lsm_tpu_torch.ops import weno_v2 as tv2
from lsm_tpu_torch.utils.checkpoint import field_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _vortex(m):
    """Config 3's swirl in x-y, reversing in time, with a drift along z that
    grows with t; the same code for jnp (``m = jnp``) and torch (the CFL
    bound passes ``t`` as a number, the stages as a tensor or a traced
    value)."""
    def f(xs, t):
        x, y, z = xs
        arg = math.pi * t / 4.0
        mod = math.cos(arg) if isinstance(arg, float) else m.cos(arg)
        return (-(m.sin(math.pi * x) ** 2) * m.sin(2.0 * math.pi * y) * mod + 0.0 * z,
                m.sin(2.0 * math.pi * x) * m.sin(math.pi * y) ** 2 * mod + 0.0 * z,
                0.1 + 0.2 * t + 0.0 * (x + y + z))
    return f


def _speed(m):
    """A speed that changes sign across the domain and in time."""
    return lambda xs, t: 0.3 * xs[0] - 0.1 * (xs[1] + xs[2]) + 0.05 + 0.2 * t + 0.05 * m.tanh(
        xs[2])


def _program(kind, fn):
    prog = cp.trace(fn, 3, tv2.n_components(kind))
    assert isinstance(prog, cp.Program), prog
    return tv2.TermSpec(kind, "program", prog), ()


def _terms(entry):
    """The same term list for both packages: JAX's analytic specs and the
    port's program specs."""
    if entry == "advection":
        return ((jv2.TermSpec("advection", "analytic", _vortex(jnp), 0), ()),), (
            _program("advection", _vortex(torch)),)
    return ((jv2.TermSpec("advection", "analytic", _vortex(jnp), 0), ()),
            (jv2.TermSpec("normal", "analytic", _speed(jnp), 0), ()),
            (jv2.TermSpec("curvature", "const", -0.05, 0), ())), (
        _program("advection", _vortex(torch)), _program("normal", _speed(torch)),
        (tv2.TermSpec("curvature", "const", -0.05, 0), ()))


def _fields(shape, bc="mixed", seed=0):
    args = ((-0.2, 0.1, 0.0), (1.1, 0.9, 1.3), shape)
    jg, tg = J.Grid(*args), T.Grid(*args)
    mk = {"mixed": lambda m: [(m.Symmetry(), m.Extrapolation(1)), m.Periodic(),
                              (m.Extrapolation(2), m.Symmetry())],
          "periodic": lambda m: m.Periodic()}[bc]
    jphi = J.sample(jshapes.sphere((0.45, 0.5, 0.6), 0.3), jg, mk(J), dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    vals = np.array(jphi.values) + 1e-3 * rng.standard_normal(shape)
    jphi = jphi.with_values(jnp.asarray(vals))
    tphi = field_from_numpy(vals, tg, mk(T), device="cpu")
    return jg, tg, jphi, tphi, rng


ORIGIN = (3.0, -5.0, 7.0)


@pytest.mark.parametrize("origin", [None, ORIGIN], ids=["origin0", "origin"])
@pytest.mark.parametrize("with_aux", [False, True], ids=["noaux", "aux"])
@pytest.mark.parametrize("entry", ["advection", "terms"])
def test_program_stage_matches_jax_reference(entry, with_aux, origin):
    """K1″'s plain version (the advection-only entry for one advection
    program, the term-list entry otherwise) against JAX's ``stage_reference``
    with the callables evaluated at ``lo + (origin + i)*h``."""
    shape = (12, 14, 16)
    jg, tg, jphi, tphi, rng = _fields(shape)
    jterms, tterms = _terms(entry)
    aux = rng.standard_normal(shape) if with_aux else None
    coeffs, t = ((0.75, 0.25, 2.5e-3) if with_aux else (0.0, 1.0, 1e-2)), 0.3
    JP = jv2.pack_padded(jphi.values, jphi.bcs)
    JA = None if aux is None else jv2.pack_padded(jnp.asarray(aux), jphi.bcs)
    TP = tv2.pack_padded(tphi.values, tphi.bcs)
    TA = None if aux is None else tv2.pack_padded(torch.from_numpy(aux), tphi.bcs)
    jref = np.asarray(jv2.stage_reference(JP, jterms, coeffs, t, JA, jphi.bcs, jg.spacing,
                                          shape, jg.lo, origin=origin))
    out = tv2.fused_stage(TP, tterms, coeffs, TA, tg.spacing, shape, tv2.Where(tg.lo, origin, t))
    assert tv2.fused_stage.launches == tv2.fused_stage.program_launches == 0
    got = _np(tv2.unpack_padded(out, shape))
    tol = 1e-12 * max(np.abs(jref).max(), 1.0)
    np.testing.assert_allclose(got, jref, rtol=0, atol=tol)
    tref = tv2.stage_reference(TP, tterms, coeffs, t, TA, tphi.bcs, tg.spacing, shape, tg.lo,
                               origin)
    np.testing.assert_allclose(_np(tref), jref, rtol=0, atol=tol)


def test_program_stage_matches_jax_interpret():
    """One case against JAX's Pallas stage in interpret mode (its lane axis
    needs 128 nodes): the term list with aux at a nonzero origin."""
    shape = (8, 8, 128)
    jg, tg, jphi, tphi, rng = _fields(shape, bc="periodic", seed=4)
    jterms, tterms = _terms("terms")
    aux = rng.standard_normal(shape)
    coeffs, t = (0.75, 0.25, 2.5e-3), 0.7
    JP, JA = jv2.pack_padded(jphi.values, jphi.bcs), jv2.pack_padded(jnp.asarray(aux), jphi.bcs)
    jout = jv2.unpack_padded(jv2.fused_stage(JP, jterms, coeffs, t, JA, jphi.bcs, jg.spacing,
                                             shape, jg.lo, interpret=True, origin=ORIGIN), shape)
    out = tv2.fused_stage(tv2.pack_padded(tphi.values, tphi.bcs), tterms, coeffs,
                          tv2.pack_padded(torch.from_numpy(aux), tphi.bcs), tg.spacing, shape,
                          tv2.Where(tg.lo, ORIGIN, t))
    jout = np.asarray(jout)
    np.testing.assert_allclose(_np(tv2.unpack_padded(out, shape)), jout, rtol=0,
                               atol=1e-12 * max(np.abs(jout).max(), 1.0))


@pytest.mark.parametrize("kind", ["advection", "normal"])
def test_integrate_with_a_program_matches_jax(kind):
    """``integrate`` on the fused stepper (the program route, plain versions
    on the CPU) against JAX's ``integrate``, RK3, f64."""
    shape = (12, 14, 16)
    _, _, jphi, tphi, _ = _fields(shape, seed=7)
    jterm = J.AdvectionTerm(_vortex(jnp)) if kind == "advection" else J.NormalMotionTerm(
        _speed(jnp))
    tterm = T.AdvectionTerm(_vortex(torch)) if kind == "advection" else T.NormalMotionTerm(
        _speed(torch))
    assert tfused.FusedStepper((tterm,), tphi, T.RK3()).routes == (("program", None),)
    jeq = J.LevelSetEquation(terms=jterm, ic=jphi, integrator=J.RK3(), t=0.1)
    teq = T.LevelSetEquation(terms=tterm, ic=tphi, integrator=T.RK3(), t=0.1)
    jeq.integrate(0.1 + 4.5 * 0.5 * float(J.compute_cfl((jterm,), jphi, 0.1)))
    teq.integrate(jeq.t)
    assert teq.last_fast_path == "fused" and teq.t == jeq.t
    want = np.asarray(jeq.state.values)
    np.testing.assert_allclose(_np(teq.state.values), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_rollout_time_gradients_through_a_program_match_jax():
    """``rollout`` with a time-dependent program velocity: the loss and its
    gradients w.r.t. phi0, t0 and dt (through K3″'s plain version: the time
    cotangent from autograd of the program's evaluation) against JAX's."""
    shape = (10, 12, 14)
    jg, _, jphi, tphi, _ = _fields(shape, bc="periodic", seed=9)
    dt0, t00 = 0.25 * jg.min_spacing, 0.2

    def jloss(v, t0, dt):
        out, _ = J.rollout(J.RK3(), (J.AdvectionTerm(_vortex(jnp)),), jphi.with_values(v), t0,
                           dt, 3, fast="off")
        return jnp.sum(out.values ** 2)

    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jphi.values, jnp.asarray(t00), jnp.asarray(dt0))
    v = tphi.values.clone().requires_grad_()
    t0 = torch.tensor(t00, dtype=torch.float64, requires_grad=True)
    dt = torch.tensor(dt0, dtype=torch.float64, requires_grad=True)
    out, _ = T.rollout(T.RK3(), (T.AdvectionTerm(_vortex(torch)),), tphi.with_values(v), t0,
                       dt, 3)
    loss = (out.values ** 2).sum()
    grads = torch.autograd.grad(loss, (v, t0, dt))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-12 * abs(float(jl))
    for g, jgr in zip(grads, jgrads):
        jgr = np.asarray(jgr)
        np.testing.assert_allclose(_np(g), jgr, rtol=0, atol=1e-12 * np.abs(jgr).max())


def test_band_stage_program_matches_jax_reference():
    """K6″'s plain version (a program velocity, nothing tile-packed for it)
    against JAX's ``band_stage_reference`` with the callable, over the
    active tiles; other tiles keep the target's values."""
    shape, tiles = (16, 16, 128), (8, 8, 128)
    grid = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape)
    jphi = J.sample(jshapes.sphere((0.5, 0.5, 0.5), 0.3), J.Grid(*grid), J.Extrapolation(2),
                    dtype=jnp.float64)
    tphi = field_from_numpy(np.array(jphi.values), T.Grid(*grid), T.Extrapolation(2),
                            device="cpu")
    jnb, tnb = J.NarrowBandField.from_field(jphi), T.NarrowBandField.from_field(tphi)
    jQ, tP = bp.pack_band_padded(jnb.values, jnb.bcs), tv2.pack_padded(tnb.values, tnb.bcs)
    band = (tnb.compute_mask.to(torch.uint8) + tnb.mask.to(torch.uint8)).contiguous()
    ids, _ = bd.active_tile_ids(tnb.compute_mask, tiles, 8)
    coeffs, t = (0.0, 1.0, 1e-3), 0.4
    jspecs = ((jv2.TermSpec("advection", "analytic", _vortex(jnp), 0), ()),)
    jout = bp.band_stage_reference(jQ, jQ + 7.0, None, jnb.compute_mask, jspecs, coeffs, t,
                                   None, jnb.bcs, jnb.grid.spacing, shape, jnb.grid.lo, tiles)
    tout = bd.band_stage(tP, tP + 7.0, ids, band, (_program("advection", _vortex(torch)),),
                         coeffs, None, tnb.grid.spacing, shape, tiles,
                         tv2.Where(tnb.grid.lo, None, t))
    assert bd.band_stage.launches == bd.band_stage.program_launches == 0
    want = np.asarray(bp.unpack_band_padded(jout, shape))
    np.testing.assert_allclose(_np(tv2.unpack_padded(tout, shape)), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_band_stepper_keeps_no_coordinates_for_a_program():
    """A traced callable on the band stepper: no per-slot coordinates, no
    streams; one that does not trace keeps both, as before."""
    g = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (24, 24, 24))
    nb = T.NarrowBandField.from_field(T.sample(tshapes.sphere((0.5, 0.5, 0.5), 0.3), g,
                                               T.Extrapolation(2), dtype=torch.float64,
                                               device="cpu"))
    traced = tband.FusedBandStepper((T.AdvectionTerm(_vortex(torch)),), nb, T.RK3())
    state = traced.pack(nb)
    assert state.xs is None and state.coefs == ((),)
    one = torch.ones((), dtype=torch.float64)  # a captured tensor: the stream route
    untraced = lambda xs, t: tuple(one * c for c in _vortex(torch)(xs, t))
    other = tband.FusedBandStepper((T.AdvectionTerm(untraced),), nb, T.RK3())
    assert other.pack(nb).xs is not None and other.entries[0][0].route == "stream"
    dt = 0.25 * g.min_spacing
    a = traced.unpack(traced.step(state, 0.3, dt))
    b = other.unpack(other.step(other.pack(nb), 0.3, dt))
    torch.testing.assert_close(a.values, b.values, rtol=0, atol=1e-14)


def _updates(m, kind):
    """``update_func`` terms for both packages: a program velocity that each
    refresh replaces by one streamed from the state, or a normal speed
    following the state."""
    pkg = J if m is jnp else T
    if kind == "advection":  # JAX's kernels take no callable closing over the state
        def upd(vel, phi, t):
            v = phi.values
            return pkg.MeshField(m.stack([0.3 + 0.1 * m.tanh(v), -0.2 + 0.0 * v, 0.1 * v + t]),
                                 phi.grid)
        return pkg.AdvectionTerm(_vortex(m), update_func=upd)

    def speed(s, phi, t):
        return pkg.MeshField(0.05 + 0.02 * m.tanh(phi.values) + 0.1 * t, phi.grid)

    return pkg.NormalMotionTerm(0.05, update_func=speed)


@pytest.mark.parametrize("kind", ["advection", "normal"])
def test_update_func_matches_jax_fused_path(kind):
    """``integrate`` with an ``update_func`` term on the port's fused stepper
    against JAX's fused ``update_func`` path (interpret mode; its lane axis
    needs 128 nodes), RK3, f64: the state, the time and the refreshed
    terms."""
    shape = (8, 8, 128)
    _, _, jphi, tphi, _ = _fields(shape, bc="periodic", seed=11)
    jeq = J.LevelSetEquation(terms=_updates(jnp, kind), ic=jphi, integrator=J.RK3())
    teq = T.LevelSetEquation(terms=_updates(torch, kind), ic=tphi, integrator=T.RK3())
    jeq.integrate(1.0, max_steps=3, fast="interpret")
    teq.integrate(1.0, max_steps=3)
    assert jeq.last_fast_path == teq.last_fast_path == "fused"
    assert abs(teq.t - jeq.t) <= 1e-14 * jeq.t and teq.last_nsteps == 3
    want = np.asarray(jeq.state.values)
    np.testing.assert_allclose(_np(teq.state.values), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    if kind == "normal":  # the terms persist as the last refresh left them
        np.testing.assert_allclose(_np(teq.terms[0].speed.values),
                                   np.asarray(jeq.terms[0].speed.values), rtol=0, atol=1e-12)
