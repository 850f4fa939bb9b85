"""The port's stencils, geometry helpers and Hamilton-Jacobi terms against the
JAX package, on the CPU in float64: ENO2 one-sided derivatives, Godunov
norms, mixed second derivatives and the mean curvature on padded tensors;
each term's ``rhs``, ``cfl_dt`` (dense and on a band's active mask) and
``update``; ``EikonalReinitializationTerm.from_initial``. Fields: a sphere
and a torus, under the five boundary-condition kinds. Tolerance
``1e-12 * max(|ref|, 1)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.geometry import queries as jgeo
from lsm_tpu.models import shapes as jshapes
from lsm_tpu.ops import stencils as jst
from lsm_tpu_torch.geometry import queries as tgeo
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.ops import stencils as tst
from lsm_tpu_torch.utils.checkpoint import field_from_numpy

SHAPE = (14, 16, 18)
BCS = {"periodic": lambda m: m.Periodic(), "symmetry": lambda m: m.Symmetry(),
       "neumann": lambda m: m.Neumann(), "linear": lambda m: m.LinearExtrapolation(),
       "extrap2": lambda m: m.Extrapolation(2)}
FIELDS = {"sphere": lambda m: m.sphere((0.1, -0.05, 0.2), 0.55),
          "torus": lambda m: m.torus((0.05, 0.0, -0.1), 0.5, 0.2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _close(got, ref, tol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(got - ref).max()) <= tol * scale


def _pair(field="torus", bc="extrap2", shape=SHAPE):
    """The same field in both packages (float64, CPU)."""
    grid = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), shape)
    jphi = J.sample(FIELDS[field](jshapes), J.Grid(*grid), BCS[bc](J), dtype=jnp.float64)
    tphi = field_from_numpy(np.array(jphi.values), T.Grid(*grid), BCS[bc](T), device="cpu")
    return jphi, tphi


@pytest.mark.parametrize("bc", list(BCS))
@pytest.mark.parametrize("field", list(FIELDS))
def test_stencils_and_curvature_match_jax(field, bc):
    jphi, tphi = _pair(field, bc)
    jp, tp = jphi.pad(2), tphi.pad(2)
    sp = jphi.spacing
    for ax, h in enumerate(sp):
        for got, ref in zip(tst.eno2_onesided(tp, ax, h, 2, SHAPE),
                            jst.eno2_onesided(jp, ax, h, 2, SHAPE)):
            _close(_np(got), ref)
    for got, ref in zip(tst.godunov_norms(tp, sp, 2, SHAPE), jst.godunov_norms(jp, sp, 2, SHAPE)):
        _close(_np(got), ref)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        _close(_np(tst.d2_mixed(tp, a, b, sp[a], sp[b], 2, SHAPE)),
               jst.d2_mixed(jp, a, b, sp[a], sp[b], 2, SHAPE))
    _close(_np(tgeo.curvature_from_padded(tp, sp, 2, SHAPE)),
           jgeo.curvature_from_padded(jp, sp, 2, SHAPE))
    _close(_np(tgeo.grad_norm_from_padded(tp, sp, 2, SHAPE)),
           jgeo.grad_norm_from_padded(jp, sp, 2, SHAPE))


def test_minmod_ties_and_underflow():
    """Zero unless the product is positive (an underflowing product counts
    as a sign change); ``x`` on a tie of magnitudes."""
    x = np.array([1.0, -2.0, 3.0, 1e-200, 2.0, -2.0, 0.0])
    y = np.array([2.0, -1.0, -3.0, 1e-200, 2.0, -2.0, 5.0])
    got = _np(tst.minmod(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_array_equal(got, np.asarray(jst.minmod(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(got, [1.0, -1.0, 0.0, 0.0, 2.0, -2.0, 0.0])


def _speed(xs, t):
    return 0.1 + 0.05 * xs[0] - 0.2 * t + 0.0 * (xs[1] + xs[2])


def _terms(kind, jphi, tphi):
    """(JAX term, port term) of one coefficient form."""
    rng = np.random.default_rng(7)
    field = rng.standard_normal(SHAPE)
    field[::3] = 0.0  # ties: zero speed / zero weight
    jmf = lambda a: J.MeshField(jnp.asarray(a), jphi.grid, jphi.bcs)
    tmf = lambda a: T.MeshField(torch.from_numpy(a.copy()), tphi.grid, tphi.bcs)
    if kind == "normal_const":
        return J.NormalMotionTerm(0.2), T.NormalMotionTerm(0.2)
    if kind == "normal_stream":
        return J.NormalMotionTerm(jmf(field)), T.NormalMotionTerm(tmf(field))
    if kind == "normal_callable":
        return J.NormalMotionTerm(_speed), T.NormalMotionTerm(_speed)
    if kind == "curvature_const":
        return J.CurvatureTerm(-0.05), T.CurvatureTerm(-0.05)
    if kind == "curvature_stream":
        return J.CurvatureTerm(jmf(-np.abs(field))), T.CurvatureTerm(tmf(-np.abs(field)))
    if kind == "eikonal_none":
        return J.EikonalReinitializationTerm(), T.EikonalReinitializationTerm()
    if kind == "eikonal_frozen":
        return (J.EikonalReinitializationTerm.from_initial(jphi),
                T.EikonalReinitializationTerm.from_initial(tphi))
    raise ValueError(kind)


KINDS = ["normal_const", "normal_stream", "normal_callable", "curvature_const",
         "curvature_stream", "eikonal_none", "eikonal_frozen"]


@pytest.mark.parametrize("kind", KINDS)
def test_term_rhs_and_cfl_match_jax(kind):
    """``rhs`` on both fields under every BC kind; ``cfl_dt`` dense and on
    a band's active mask."""
    for field in FIELDS:
        for bc in BCS:
            jphi, tphi = _pair(field, bc)
            jterm, tterm = _terms(kind, jphi, tphi)
            assert tterm.pad_width == jterm.pad_width == 2
            _close(_np(tterm.rhs(tphi, 0.3)), jterm.rhs(jphi, 0.3))
    jphi, tphi = _pair("torus", "extrap2")
    jterm, tterm = _terms(kind, jphi, tphi)
    dt = tterm.cfl_dt(tphi, 0.3)
    assert dt.dtype == torch.float64 and dt.shape == ()
    _close(_np(dt), jterm.cfl_dt(jphi, 0.3))
    jnb, tnb = J.NarrowBandField.from_field(jphi), T.NarrowBandField.from_field(tphi)
    np.testing.assert_array_equal(_np(tnb.mask), np.asarray(jnb.mask))
    _close(_np(tterm.cfl_dt(tnb, 0.3)), jterm.cfl_dt(jnb, 0.3))


def test_update_refreshes_normal_speed_and_keeps_the_others():
    jphi, tphi = _pair()
    grow = lambda speed, phi, t: 2.0 * speed + t  # numbers and fields alike
    jterm = J.NormalMotionTerm(0.1, update_func=grow).update(jphi, 0.5)
    tterm = T.NormalMotionTerm(0.1, update_func=grow).update(tphi, 0.5)
    assert tterm.speed == jterm.speed == 0.7 and tterm.update_func is grow
    _close(_np(tterm.rhs(tphi, 0.5)), jterm.rhs(jphi, 0.5))
    for kind in ("normal_const", "curvature_const", "eikonal_none", "eikonal_frozen"):
        term = _terms(kind, jphi, tphi)[1]
        assert term.update(tphi, 0.1) is term


def test_from_initial_freezes_the_smoothed_sign():
    jphi, tphi = _pair("sphere", "linear")
    jterm = J.EikonalReinitializationTerm.from_initial(jphi)
    tterm = T.EikonalReinitializationTerm.from_initial(tphi)
    _close(_np(tterm.s0.values), jterm.s0.values)
    assert tterm.s0.grid == tphi.grid and tterm.s0.bcs == tphi.bcs
    doubled = tphi.map(lambda v: 2.0 * v)
    assert torch.equal(doubled.values, 2.0 * tphi.values) and doubled.grid == tphi.grid


def test_torus_matches_jax():
    xs = np.linspace(-1.0, 1.0, 9)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    want = np.asarray(jshapes.torus((0.1, 0.0, -0.2), 0.5, 0.2)(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Z)))
    got = tshapes.torus((0.1, 0.0, -0.2), 0.5, 0.2)(
        torch.from_numpy(X), torch.from_numpy(Y), torch.from_numpy(Z))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-15)


def test_general_path_integrate_matches_jax():
    """The general path (``rhs`` + RK stages) of curvature plus normal motion."""
    jphi, tphi = _pair("torus", "extrap2")
    jterms = (J.CurvatureTerm(-0.05), J.NormalMotionTerm(_speed))
    tterms = (T.CurvatureTerm(-0.05), T.NormalMotionTerm(_speed))
    jeq = J.LevelSetEquation(terms=jterms, ic=jphi, integrator=J.RK2())
    teq = T.LevelSetEquation(terms=tterms, ic=tphi, integrator=T.RK2())
    jeq.integrate(1.0, max_steps=2, fast="off")
    teq.integrate(1.0, max_steps=2, fast="off")
    assert teq.last_fast_path is None and teq.t == pytest.approx(jeq.t, abs=1e-15)
    _close(_np(teq.state.values), jeq.state.values, tol=1e-10)
