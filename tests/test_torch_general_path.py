"""The port's general path against the JAX package, on the CPU in float64:
``integrate`` with hooks and with ``fast="off"`` (dense 3D and a 3D band),
the integrators' stage routing through ``fused_stage_term`` (one K10/K11
pass per stage for a single WENO5 advection term), ``rollout(fast="off")``
gradients, and the CUDA route table (``_cuda_stepper``, which a CUDA state
takes; checked here without a card, as the refusals raise before any
arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.models import shapes as jshapes
from lsm_tpu_torch.integrators import explicit as texplicit
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.terms import terms as tterms
from lsm_tpu_torch.utils.checkpoint import field_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _velf(xs, t):
    # rigid rotation about the z axis plus a time-dependent drift along z;
    # u1 is exactly 0 on x = 0.5 (tie cells); jnp and torch alike
    return (0.5 - xs[1] + 0.0 * (xs[0] + xs[2]), xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
            0.1 + 0.5 * t + 0.0 * (xs[0] + xs[1] + xs[2]))


INTEG = {"fe": (J.ForwardEuler, T.ForwardEuler), "rk2": (J.RK2, T.RK2),
         "rk3": (J.RK3, T.RK3)}


def _dense_pair(shape=(12, 14, 16)):
    """The Zalesak sphere in both packages, mixed BCs (f64, CPU)."""
    args = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape)
    jb = [J.Periodic(), J.Symmetry(), J.LinearExtrapolation()]
    tb = [T.Periodic(), T.Symmetry(), T.LinearExtrapolation()]
    jphi = J.sample(jshapes.zalesak_sphere(), J.Grid(*args), jb, dtype=jnp.float64)
    tphi = field_from_numpy(np.array(jphi.values), T.Grid(*args), tb, device="cpu")
    return jphi, tphi


def _band_pair(shape=(20, 20, 24)):
    args = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape)
    jphi = J.sample(jshapes.sphere((0.5, 0.5, 0.5), 0.3), J.Grid(*args), J.Extrapolation(2),
                    dtype=jnp.float64)
    tphi = field_from_numpy(np.array(jphi.values), T.Grid(*args), T.Extrapolation(2),
                            device="cpu")
    return J.NarrowBandField.from_field(jphi), T.NarrowBandField.from_field(tphi)


@pytest.mark.parametrize("mode", ["posthook", "off"])
@pytest.mark.parametrize("integ", list(INTEG))
def test_integrate_general_path_matches_jax(integ, mode):
    """Dense 3D: ``integrate`` with a posthook, or with ``fast="off"``,
    against JAX's general path, with equal step counts."""
    jI, tI = INTEG[integ]
    jphi, tphi = _dense_pair()
    tf = 0.05
    jsteps, tsteps = [], []
    jeq = J.LevelSetEquation(terms=J.AdvectionTerm(_velf), ic=jphi, integrator=jI())
    jeq.integrate(tf, posthook=lambda e: jsteps.append(e.t))
    teq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi, integrator=tI())
    if mode == "posthook":
        teq.integrate(tf, posthook=lambda e: tsteps.append(e.t))
    else:
        teq.integrate(tf, fast="off")
        tsteps = [None] * teq.last_nsteps
    assert teq.last_fast_path is None and len(tsteps) == len(jsteps) >= 2
    assert teq.t == jeq.t == tf
    np.testing.assert_allclose(_np(teq.state.values), np.asarray(jeq.state.values), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("integ", ["fe", "rk3"])
def test_band_with_hooks_matches_jax(integ):
    """A 3D band with a posthook: the general path over the band's dense
    values (K10's plain version), re-tubed after every step; masks equal."""
    jI, tI = INTEG[integ]
    jnb, tnb = _band_pair()
    tf = 0.04
    jn, tn = [], []
    jeq = J.LevelSetEquation(terms=J.AdvectionTerm(_velf), ic=jnb, integrator=jI())
    jeq.integrate(tf, posthook=lambda e: jn.append(e.t))
    teq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tnb, integrator=tI())
    teq.integrate(tf, posthook=lambda e: tn.append(e.t))
    assert teq.last_fast_path is None and len(tn) == len(jn) >= 2
    assert isinstance(teq.state, T.NarrowBandField)
    np.testing.assert_array_equal(_np(teq.state.mask), np.asarray(jeq.state.mask))
    np.testing.assert_allclose(_np(teq.state.values), np.asarray(jeq.state.values), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("terms_kind", ["weno5", "upwind", "sum"])
def test_stage_routes_through_fused_stage_term(terms_kind, monkeypatch):
    """One WENO5 advection term: every stage is one ``stage_values`` call
    (one K10/K11 pass); any other list takes the terms' rhs and an axpy."""
    calls, rhs = [], []
    stage_values = tterms.AdvectionTerm.stage_values
    total_rhs = texplicit.total_rhs
    monkeypatch.setattr(tterms.AdvectionTerm, "stage_values",
                        lambda self, *a: calls.append(a[3]) or stage_values(self, *a))
    monkeypatch.setattr(texplicit, "total_rhs", lambda *a: rhs.append(1) or total_rhs(*a))
    _, tphi = _dense_pair((8, 9, 10))
    terms = {"weno5": (T.AdvectionTerm(_velf),),
             "upwind": (T.AdvectionTerm(_velf, "upwind"),),
             "sum": (T.AdvectionTerm(_velf), T.CurvatureTerm(-0.01))}[terms_kind]
    assert (tterms.fused_stage_term(terms) is terms[0]) == (terms_kind == "weno5")
    T.RK3().advance(terms, tphi, 0.0, 1e-3)
    if terms_kind == "weno5":
        assert len(calls) == 3 and not rhs
        assert calls[2] == pytest.approx((1 / 3, 2 / 3, 2 / 3 * 1e-3))
    else:
        assert not calls and len(rhs) == 3


def test_rollout_general_path_gradients_match_jax():
    """``rollout(fast="off")`` at 12^3, float64: gradients w.r.t. the initial
    values, a streamed velocity and ``dt`` against ``jax.grad`` of JAX's
    ``rollout(fast="off")`` (the port's backward: the plain VJP of K10)."""
    shape = (12, 12, 12)
    jphi, tphi = _dense_pair(shape)
    rng = np.random.default_rng(3)
    vals = np.array(jphi.values) + 1e-3 * rng.standard_normal(shape)
    vel = 0.5 * rng.standard_normal((3, *shape))
    dt0 = 0.25 * jphi.grid.min_spacing

    def jloss(v, u, dt):
        term = J.AdvectionTerm(J.MeshField(u, jphi.grid))
        out, _ = J.rollout(J.RK3(), (term,), jphi.with_values(v), 0.0, dt, 3, fast="off")
        return jnp.sum(out.values ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(vals), jnp.asarray(vel),
                                            jnp.asarray(dt0))
    v = torch.from_numpy(vals).requires_grad_()
    u = torch.from_numpy(vel).requires_grad_()
    dt = torch.tensor(dt0, dtype=torch.float64, requires_grad=True)
    term = T.AdvectionTerm(T.MeshField(u, tphi.grid))
    out, _ = T.rollout(T.RK3(), (term,), tphi.with_values(v), 0.0, dt, 3, fast="off")
    tg = torch.autograd.grad((out.values ** 2).sum(), (v, u, dt))
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        assert float(np.abs(_np(a) - b).max()) <= 1e-9 * max(float(np.abs(b).max()), 1.0)


def test_cuda_route_table():
    """What ``_cuda_stepper`` does with each configuration: hooks,
    ``fast="off"``, the upwind scheme and an object that is no term kind take
    the general path (``None``); a dense 2D field takes the fused stepper,
    a 2D band the band stepper; Extrapolation(8) takes the fused stepper,
    equal to JAX's step (on an axis of 8 nodes, too few for it, the general
    path);
    ``update_func`` takes the fused stepper on a dense field and the general
    path on a band, as in JAX."""
    _, tphi = _dense_pair((8, 8, 8))
    _, tnb = _band_pair((16, 16, 16))
    g2 = T.Grid((0.0, 0.0), (1.0, 1.0), (16, 16))
    phi2 = T.sample(tshapes.circle((0.5, 0.5), 0.3), g2, T.Extrapolation(1),
                    dtype=torch.float64, device="cpu")
    vel2 = lambda xs, t: (0.5 - xs[1] + 0.0 * xs[0], xs[0] - 0.5 + 0.0 * xs[1])
    adv = T.AdvectionTerm(_velf)

    class Other:
        def update(self, phi, t):
            return self

    def route(terms, ic, hooks=False, fast="auto"):
        return T.LevelSetEquation(terms=terms, ic=ic)._cuda_stepper(hooks, fast)

    assert route(adv, tphi, hooks=True) is None
    assert route(adv, tphi, fast="off") is None
    assert route(T.AdvectionTerm(_velf, "upwind"), tphi) is None
    assert route((Other(),), tphi) is None
    assert route(adv, tnb, hooks=True) is None
    assert isinstance(route(adv, tnb), T.integrators.band_fused.FusedBandStepper)
    stepper = route(T.AdvectionTerm(vel2), phi2)
    assert isinstance(stepper, tfused.FusedStepper) and stepper.shape == (16, 16)
    upd = T.AdvectionTerm(_velf, update_func=lambda v, p, t: v)
    assert isinstance(route(upd, tphi), tfused.FusedStepper)
    assert route(upd, tnb) is None
    band2 = route(T.AdvectionTerm(vel2), T.NarrowBandField.from_field(phi2))
    assert isinstance(band2, T.integrators.band_fused.FusedBandStepper) and band2.shape == (16, 16)
    # Extrapolation(8) on an axis of 8 nodes is an error (the general path's
    # ValueError, as in JAX); on 10 nodes it takes the fused stepper (the
    # ghost kernels' table route), whose step equals JAX's
    assert route((adv,), tphi.with_bcs(T.Extrapolation(8), replace=True)) is None
    jdeep, deep = _dense_pair((10, 10, 10))
    jdeep, deep = (jdeep.with_bcs(J.Extrapolation(8), replace=True),
                   deep.with_bcs(T.Extrapolation(8), replace=True))
    assert isinstance(route((adv,), deep), tfused.FusedStepper)
    assert route((adv,), deep, hooks=True) is None  # with hooks: the general path
    teq = T.LevelSetEquation(terms=adv, ic=deep)
    teq.integrate(0.02, max_steps=2)
    jeq = J.LevelSetEquation(terms=J.AdvectionTerm(_velf), ic=jdeep)
    jeq.integrate(0.02, max_steps=2)
    assert teq.last_fast_path == "fused" and teq.t == jeq.t
    want = np.asarray(jeq.state.values)
    assert float(np.abs(_np(teq.state.values) - want).max()) <= 1e-12 * np.abs(want).max()


def test_hooks_see_each_step_and_may_swap_the_state():
    """A posthook runs once per accepted step after the step (JAX's hook
    loop); a prehook may replace the state, and the next step starts from
    it (the reference's reinitialization idiom)."""
    _, tphi = _dense_pair((10, 10, 10))
    seen = []
    eq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi)
    eq.integrate(1.0, max_steps=3, posthook=lambda e: seen.append((e.t, e.last_nsteps)))
    assert [n for _, n in seen] == [1, 2, 3] and seen[-1][0] == eq.t

    def reset(e):
        e.state = e.state.with_values(torch.zeros_like(e.state.values) + 0.25)

    eq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi)
    eq.integrate(1.0, max_steps=2, prehook=reset)
    np.testing.assert_allclose(_np(eq.state.values), 0.25, rtol=0, atol=1e-14)
