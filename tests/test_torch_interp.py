"""The port's interpolation and Newton signed distance against the JAX
package on the CPU, in float64 at small seeded sizes: the Bernstein algebra,
``InterpolatedField`` (eager and lazy) values, gradients and Hessians, cell
extrema and patches, ``NewtonSDF`` samples, seed grid and queries (host and
capacity builds), ``reinitialize_newton`` with its overflow modes, and
``hausdorff_distance``. JAX's objects are built once per module.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.interp import bernstein as jb
from lsm_tpu_torch.interp import bernstein as tb
from lsm_tpu_torch.interp.interpolation import interpolation_matrix as t_matrix
from lsm_tpu.interp.interpolation import interpolation_matrix as j_matrix

TOL = 1e-12


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _fields(shape, seed=0, radius=0.45):
    """A noisy sphere (circle) on [-1, 1]^N in both packages, Extrapolation(2)."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    axes = [np.linspace(-1.0, 1.0, n) for n in shape]
    xs = np.meshgrid(*axes, indexing="ij")
    vals = np.sqrt(sum(x ** 2 for x in xs)) - radius + 0.002 * rng.standard_normal(shape)
    lo, hi = (-1.0,) * ndim, (1.0,) * ndim
    jphi = J.MeshField(jnp.asarray(vals), J.Grid(lo, hi, shape), J.Extrapolation(2))
    tphi = T.MeshField(torch.from_numpy(vals), T.Grid(lo, hi, shape), T.Extrapolation(2))
    return jphi, tphi


def _points(n, ndim, seed=1, span=0.95):
    return np.random.default_rng(seed).uniform(-span, span, (n, ndim))


# -- Bernstein ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_bernstein_algebra_matches_jax(ndim):
    rng = np.random.default_rng(ndim)
    degs = (3, 4, 2)[:ndim]
    c = rng.standard_normal(tuple(d + 1 for d in degs))
    lo, hi = -rng.random(ndim), 1.0 + rng.random(ndim)
    xs = lo + rng.random((7, ndim)) * (hi - lo)
    xs[0] = lo  # the box's corners: 0^0 at the endpoints
    xs[1] = hi
    for deg in degs:
        t = rng.random(5)
        _close(tb.bernstein_basis(deg, torch.from_numpy(t)), jb.bernstein_basis(deg, t))
    tc = torch.from_numpy(c)
    jc = jnp.asarray(c)
    jv, jg, jh = jax.jit(jax.vmap(lambda p: jb.bernstein_value_grad_hess(jc, lo, hi, p)))(
        jnp.asarray(xs))
    # one point at a time and every point at once
    _close(tb.bernstein_eval(tc, lo, hi, xs[3]), jb.bernstein_eval(jc, lo, hi, xs[3]))
    _close(tb.bernstein_value_grad(tc, lo, hi, xs[3])[1], jg[3], 1e-11)
    v, g, h = tb.bernstein_value_grad_hess(tc, lo, hi, torch.from_numpy(xs))
    _close(v, jv)
    # jax.grad of the guarded 0^0 is NaN at a corner (points 0 and 1); the
    # closed form is not
    assert bool(torch.isfinite(g).all() and torch.isfinite(h).all())
    _close(g[2:], jg[2:], 1e-11)
    _close(h[2:], jh[2:], 1e-11)
    for axis in range(ndim):
        _close(tb.bernstein_derivative(tc, ndim, axis, lo, hi),
               jb.bernstein_derivative(jnp.asarray(c), ndim, axis, lo, hi))
        for a, b in zip(tb.bernstein_split(tc, ndim, axis, 0.3),
                        jb.bernstein_split(jnp.asarray(c), ndim, axis, 0.3)):
            _close(a, b)
        for side in (0, 1):
            _close(tb.bernstein_face(tc, ndim, axis, side),
                   jb.bernstein_face(jnp.asarray(c), ndim, axis, side))
    for a, b in zip(tb.bernstein_bounds(tc, ndim), jb.bernstein_bounds(jnp.asarray(c), ndim)):
        _close(a, b)


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
def test_interpolation_matrix(order):
    np.testing.assert_array_equal(t_matrix(order), j_matrix(order))


# -- InterpolatedField -------------------------------------------------------------------


@pytest.fixture(scope="module")
def fields3():
    jphi, tphi = _fields((11, 12, 13))
    return jphi, tphi, J.InterpolatedField(jphi, 3)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_interpolated_field_3d(fields3, lazy):
    jphi, tphi, jcf = fields3
    tcf = T.InterpolatedField(tphi, 3, lazy=lazy)
    assert tcf.is_lazy == lazy and not jcf.is_lazy
    x = _points(40, 3)
    x[0] = (1.2, 0.0, -1.3)  # a point outside: clamped cells
    corner = np.array([[-1.0, -1.0, -1.0], [1.0, -1.0 + 2.0 / 11, 1.0]])  # on nodes
    _close(tcf(corner), jcf(corner))  # (jax.grad is NaN there, the closed form is not)
    assert bool(torch.isfinite(tcf.value_gradient_hessian(corner)[2]).all())
    _close(tcf(torch.from_numpy(x)), jcf(x))
    _close(tcf.gradient(torch.from_numpy(x)), jcf.gradient(x))
    _close(tcf.hessian(torch.from_numpy(x)), jcf.hessian(x), 1e-11)
    v, g = tcf.value_and_gradient(x)
    jv, jg = jcf.value_and_gradient(x)
    _close(v, jv)
    _close(g, jg)
    v, g, h = tcf.value_gradient_hessian(x[3])  # a single point
    jv, jg, jh = jcf.value_gradient_hessian(x[3])
    _close(v, jv)
    _close(g, jg)
    _close(h, jh, 1e-11)
    for a, b in zip(tcf.make_interpolant((3, 4, 5)), jcf.make_interpolant((3, 4, 5))):
        _close(a, b)
    for a, b in zip(tcf.local_interpolant(x[5]), jcf.local_interpolant(x[5])):
        _close(a, b)
    mins, maxs = tcf.cell_extrema(chunk=97)
    jm, jM = jcf.cell_extrema()
    _close(mins, jm)
    _close(maxs, jM)
    for a, b in zip(tcf.cell_extrema((2, 3, 4)), jcf.cell_extrema((2, 3, 4))):
        _close(a, b)
    for surface in (False, True):
        np.testing.assert_array_equal(_np(tcf.proven_empty(surface=surface)),
                                      np.asarray(jcf.proven_empty(surface=surface)))


@pytest.mark.parametrize("order", [2, 4])
def test_interpolated_field_2d_orders(order):
    jphi, tphi = _fields((17, 15), seed=3)
    jcf = J.InterpolatedField(jphi, order)
    x = _points(30, 2, seed=4)
    for lazy in (False, True):
        tcf = T.InterpolatedField(tphi, order, lazy=lazy)
        _close(tcf(x), jcf(x))
        _close(tcf.gradient(x), jcf.gradient(x))
        _close(tcf.hessian(x), jcf.hessian(x), 1e-11)
    # a field without BCs takes Extrapolation(order), as in JAX
    bare = T.InterpolatedField(T.MeshField(tphi.values, tphi.grid), order)
    _close(bare(x), J.InterpolatedField(J.MeshField(jphi.values, jphi.grid), order)(x))


def test_lazy_threshold_switches_to_lazy(monkeypatch):
    _, tphi = _fields((9, 9, 9))
    monkeypatch.setattr(T.InterpolatedField, "LAZY_THRESHOLD", 100)
    assert T.InterpolatedField(tphi, 3).is_lazy
    monkeypatch.setattr(T.InterpolatedField, "LAZY_THRESHOLD", 1 << 26)
    assert not T.InterpolatedField(tphi, 3).is_lazy


# -- NewtonSDF ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sdf3():
    jphi, tphi = _fields((14, 14, 14), seed=5)
    jsdf = J.NewtonSDF(jphi, order=3, upsample=1, maxiters=12)
    tsdf = T.NewtonSDF(tphi, order=3, upsample=1, maxiters=12)
    return jphi, tphi, jsdf, tsdf


def test_newton_sdf_samples_and_seed_grid(sdf3):
    _, _, jsdf, tsdf = sdf3
    (ts, tv), (js, jv) = tsdf.sample_points(), jsdf.sample_points()
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    _close(ts, js, 1e-10)
    assert int(tv.sum()) > 100
    (tp, th), (jp, jh) = tsdf._seed_grid(), jsdf._seed_grid()
    np.testing.assert_array_equal(_np(th), np.asarray(jh))
    _close(tp, jp, 1e-10)
    assert tsdf._seed_grid() is tsdf._seed_grid()  # cached on the object


def test_newton_sdf_queries(sdf3):
    _, _, jsdf, tsdf = sdf3
    x = _points(60, 3, seed=6)
    x[0] = (0.9, 0.9, 0.9)
    got = tsdf(torch.from_numpy(x))
    want = jax.jit(lambda s, p: s(p))(jsdf, jnp.asarray(x))  # one compile, not op by op
    _close(got, want, 1e-10)
    _close(tsdf(x[2]), got[2], 1e-10)  # a single point
    # a radius-0.45 sphere: the distance is |x| - r to the interpolant's accuracy
    assert np.abs(_np(got) - (np.linalg.norm(x, axis=-1) - 0.45)).max() < 0.01
    cp, ok = tsdf.closest_point(x, chunk=7)  # chunks of 7: the same results
    cp1, ok1 = tsdf.closest_point(x)
    assert torch.equal(cp, cp1) and torch.equal(ok, ok1)
    jcp, jok = jax.jit(lambda s, p: s.closest_point(p))(jsdf, jnp.asarray(x))
    _close(cp, jcp, 1e-10)
    np.testing.assert_array_equal(_np(ok), np.asarray(jok))


def test_capacity_build_and_overflow(sdf3):
    jphi, tphi, _, tsdf = sdf3
    kw = dict(order=3, upsample=1, maxiters=12)
    ncut = int((~tsdf.cf.proven_empty(surface=True)).sum())
    big = T.NewtonSDF(tphi, max_cut_cells=ncut + 5, **kw)
    assert big.overflowed.ndim == 0 and not bool(big.overflowed)
    jbig = J.NewtonSDF(jphi, max_cut_cells=ncut + 5, **kw)
    np.testing.assert_array_equal(_np(big.valid), np.asarray(jbig.valid))
    _close(big.samples, jbig.samples, 1e-10)
    small = T.NewtonSDF(tphi, max_cut_cells=ncut // 2, **kw)
    assert bool(small.overflowed) and small.samples.shape[0] == (ncut // 2) * 8
    with pytest.raises(RuntimeError, match="max_cut_cells"):
        T.reinitialize_newton(tphi, max_cut_cells=ncut // 2, on_overflow="raise", **kw)
    with pytest.warns(RuntimeWarning, match="max_cut_cells"):
        T.reinitialize_newton(tphi, max_cut_cells=ncut // 2, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.reinitialize_newton(tphi, max_cut_cells=ncut // 2, on_overflow="ignore", **kw)
    with pytest.raises(ValueError, match="on_overflow"):
        T.reinitialize_newton(tphi, on_overflow="loud")


def test_reinitialize_newton_matches_jax():
    jphi, tphi = _fields((12, 12, 12), seed=7, radius=0.5)
    kw = dict(order=3, upsample=1, maxiters=10)
    got = T.reinitialize_newton(tphi, **kw)
    want = J.reinitialize_newton(jphi, **kw)
    _close(got.values, want.values, 1e-10)
    assert got.bcs == tphi.bcs and got.values.shape == tphi.values.shape


def test_hausdorff_distance_matches_jax():
    j1, t1 = _fields((12, 12), seed=8, radius=0.5)
    j2, t2 = _fields((12, 12), seed=9, radius=0.4)
    kw = dict(order=3, upsample=1, maxiters=10)
    got = T.hausdorff_distance(T.NewtonSDF(t1, **kw), T.NewtonSDF(t2, **kw))
    want = jax.jit(J.hausdorff_distance)(J.NewtonSDF(j1, **kw), J.NewtonSDF(j2, **kw))
    _close(got, want, 1e-10)
    assert abs(float(got) - 0.1) < 0.02
