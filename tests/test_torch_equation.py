"""The port's whole slice against the JAX package, on the CPU in float64:
``LevelSetEquation.integrate`` through the fused stepper (plain versions of
the kernels on CPU tensors) and through the general path, plus the
equation's error paths and its routing of configurations outside the slice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.integrators import loop as jloop
from lsm_tpu.models import shapes as jshapes
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.models import shapes as tshapes


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
    # the same code runs on jnp arrays and torch tensors
    return (
        0.5 - xs[1] + 0.0 * (xs[0] + xs[2]),
        xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
        0.1 + 0.5 * t + 0.0 * (xs[0] + xs[1] + xs[2]),
    )


def _pair(shape, bcs=("periodic",), dtype=(jnp.float64, torch.float64)):
    args = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape)
    make = {"periodic": lambda p: p.Periodic(), "symmetry": lambda p: p.Symmetry(),
            "linear": lambda p: p.LinearExtrapolation()}
    jb = [make[b](J) for b in bcs] if len(bcs) == 3 else make[bcs[0]](J)
    tb = [make[b](T) for b in bcs] if len(bcs) == 3 else make[bcs[0]](T)
    jphi = J.sample(jshapes.zalesak_sphere(), J.Grid(*args), jb, dtype=dtype[0])
    tphi = T.sample(tshapes.zalesak_sphere(), T.Grid(*args), tb, dtype=dtype[1],
                    device="cpu")
    return jphi, tphi


def _counting(monkeypatch):
    """Count the port's accepted fused steps."""
    calls = []
    step = tfused.FusedStepper.step

    def counted(self, P, t, dt):
        calls.append(dt)
        return step(self, P, t, dt)

    monkeypatch.setattr(tfused.FusedStepper, "step", counted)
    return calls


INTEGRATORS = {"fe": (J.ForwardEuler, T.ForwardEuler), "rk2": (J.RK2, T.RK2),
               "rk3": (J.RK3, T.RK3)}


@pytest.mark.parametrize("velocity", ["stream", "callable"])
def test_integrate_matches_jax_fused_interpret(velocity, monkeypatch):
    jphi, tphi = _pair((16, 16, 128))
    if velocity == "stream":
        rng = np.random.default_rng(4)
        vel = 0.5 * rng.standard_normal((3, 16, 16, 128))
        vel[1, :, ::3] = 0.0  # tie cells
        jterm = J.AdvectionTerm(J.MeshField(jnp.asarray(vel), jphi.grid, J.Periodic()))
        tterm = T.AdvectionTerm(T.MeshField(torch.from_numpy(vel), tphi.grid, T.Periodic()))
    else:
        jterm, tterm = J.AdvectionTerm(_velf), T.AdvectionTerm(_velf)
    jeq = J.LevelSetEquation(terms=jterm, ic=jphi, integrator=J.RK3())
    teq = T.LevelSetEquation(terms=tterm, ic=tphi, integrator=T.RK3())
    steps = _counting(monkeypatch)
    jeq.integrate(1.0, max_steps=2, fast="interpret")
    teq.integrate(1.0, max_steps=2)
    assert jeq.last_fast_path == teq.last_fast_path == "fused"
    assert len(steps) == 2 and teq.t == pytest.approx(jeq.t, abs=1e-15)
    np.testing.assert_allclose(_np(teq.state.values), np.asarray(jeq.state.values),
                               rtol=0, atol=1e-10)
    assert abs(float(teq.volume()) - float(jeq.volume())) < 1e-12


@pytest.mark.parametrize("integ", list(INTEGRATORS))
@pytest.mark.parametrize("path", ["fused", "general"])
def test_integrate_matches_jax_general_path(integ, path, monkeypatch):
    """JAX's device loop (``fast="off"``) against the port's fused stepper and
    its general path, landing exactly on ``tf`` with equal step counts."""
    jI, tI = INTEGRATORS[integ]
    jphi, tphi = _pair((12, 16, 20), bcs=("periodic", "symmetry", "linear"))
    tf = 0.06
    jres = jloop.evolve(jI(), (J.AdvectionTerm(_velf),), jphi, 0.0, tf)
    jeq = J.LevelSetEquation(terms=J.AdvectionTerm(_velf), ic=jphi, integrator=jI())
    jeq.integrate(tf, fast="off")
    teq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi, integrator=tI())
    if path == "fused":
        steps = _counting(monkeypatch)
        teq.integrate(tf)
        assert teq.last_fast_path == "fused" and len(steps) == int(jres[3])
    else:
        steps = []
        teq.integrate(tf, fast="off", posthook=lambda eq: steps.append(eq.t))
        assert teq.last_fast_path is None and len(steps) == int(jres[3])
    assert teq.t == jeq.t == tf
    np.testing.assert_allclose(_np(teq.state.values), np.asarray(jeq.state.values),
                               rtol=0, atol=1e-10)
    assert abs(float(teq.volume()) - float(jeq.volume())) < 1e-12
    assert abs(float(teq.perimeter()) - float(jeq.perimeter())) < 1e-12


def test_general_path_2d_matches_jax():
    args = ((0.0, 0.0), (1.0, 1.0), (24, 20))
    vel = lambda xs, t: (0.5 - xs[1] + 0.0 * xs[0], xs[0] - 0.5 + 0.0 * xs[1])
    jphi = J.sample(jshapes.circle((0.5, 0.7), 0.2), J.Grid(*args), J.Periodic(),
                    dtype=jnp.float64)
    tphi = T.sample(tshapes.circle((0.5, 0.7), 0.2), T.Grid(*args), T.Periodic(),
                    dtype=torch.float64, device="cpu")
    for scheme in ("weno5", "upwind"):
        jeq = J.LevelSetEquation(terms=J.AdvectionTerm(vel, scheme), ic=jphi)
        teq = T.LevelSetEquation(terms=T.AdvectionTerm(vel, scheme), ic=tphi)
        jeq.integrate(0.1, fast="off")
        teq.integrate(0.1)  # 2D WENO5 takes the fused embedding, upwind the general path
        assert teq.last_fast_path == ("fused" if scheme == "weno5" else None)
        np.testing.assert_allclose(_np(teq.state.values), np.asarray(jeq.state.values),
                                   rtol=0, atol=1e-10)


def test_update_func_and_hooks_take_the_general_path():
    """Hooks take the general path; ``update_func`` (since the fused stepper
    took it) the fused one, refreshing the terms before the CFL bound and
    before each of RK2's two stages."""
    _, tphi = _pair((8, 8, 8))
    seen = []

    def upd(vel, phi, t):
        seen.append(t)
        return vel

    eq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf, update_func=upd), ic=tphi,
                            integrator=T.RK2())
    eq.integrate(0.02)
    assert eq.last_fast_path == "fused" and len(seen) == 3 * eq.last_nsteps >= 3
    assert eq.t == 0.02
    pre = []
    eq2 = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi)
    eq2.integrate(1.0, prehook=lambda e: pre.append(e.t), max_steps=2)
    assert len(pre) == 2 and 0.0 < eq2.t < 1.0


def test_chained_integrate_and_max_steps(monkeypatch):
    _, tphi = _pair((10, 12, 14))
    dt = 0.25 * tphi.grid.min_spacing
    a = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi)
    a.integrate(dt, dt_max=dt)
    a.integrate(2 * dt, dt_max=dt)
    b = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi)
    b.integrate(2 * dt, dt_max=dt)
    assert a.t == b.t == 2 * dt
    np.testing.assert_allclose(_np(a.state.values), _np(b.state.values), rtol=0, atol=1e-13)
    c = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi)
    steps = _counting(monkeypatch)
    c.integrate(1.0, dt_max=dt, max_steps=3)
    assert len(steps) == 3 and c.t == pytest.approx(3 * dt)
    assert tphi.values.data_ptr() != c.state.values.data_ptr()  # ic never mutated


def test_constructor_rules():
    _, tphi = _pair((6, 6, 6))
    bare = T.MeshField(tphi.values, tphi.grid)
    with pytest.raises(ValueError, match="no boundary conditions"):
        T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=bare)
    with pytest.raises(TypeError, match="MeshField"):
        T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi.values)
    with pytest.raises(ValueError, match="at least one term"):
        T.LevelSetEquation(terms=(), ic=tphi)
    with pytest.warns(UserWarning, match="using `bc`"):
        eq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi, bc=T.Symmetry())
    assert eq.boundary_conditions[0][0] == T.Symmetry()
    eq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=bare, bc=T.Periodic(), t=0.5)
    assert eq.current_time == 0.5 and eq.grid == tphi.grid
    assert "AdvectionTerm" in repr(eq)


def test_error_paths():
    _, tphi = _pair((8, 8, 8))
    eq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tphi, t=1.0)
    with pytest.raises(ValueError, match="before current time"):
        eq.integrate(0.5)
    with pytest.raises(ValueError, match="fast must be"):
        eq.integrate(2.0, fast="interpret")
    nan_vel = lambda xs, t: (float("nan") + 0.0 * xs[0], 0.0 * xs[1], 0.0 * xs[2])
    for fast in ("auto", "off"):
        eq = T.LevelSetEquation(terms=T.AdvectionTerm(nan_vel), ic=tphi)
        with pytest.raises(ValueError, match="invalid time-step"):
            eq.integrate(0.1, fast=fast)
    bad = tphi.with_values(tphi.values.clone())
    bad.values[2, 3, 4] = float("inf")
    for fast in ("auto", "off"):
        eq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=bad)
        with pytest.raises(ArithmeticError, match="non-finite"):
            eq.integrate(0.01, fast=fast)
    # with a hook the run returns the non-finite state, as JAX's hooked loop does
    jphi, _ = _pair((8, 8, 8))
    jbad = jphi.with_values(jnp.asarray(_np(bad.values)))
    for pkg, phi in ((J, jbad), (T, bad)):
        seen = []
        eq = pkg.LevelSetEquation(terms=pkg.AdvectionTerm(_velf), ic=phi)
        eq.integrate(0.01, posthook=lambda e: seen.append(e.t))
        assert seen and not bool(np.isfinite(np.asarray(eq.state.values)).all())


class _OtherTerm:
    def update(self, phi, t):
        return self


def test_unsupported_configurations_raise_on_the_cuda_route():
    """The CUDA route (``_cuda_stepper``, taken for CUDA states): hooks,
    ``fast="off"``, the upwind scheme and an object that is no term kind take
    the general path (``None``), a dense 2D field the fused stepper; what JAX
    takes on its fused path and the card cannot yet run raises
    NotImplementedError naming the ROADMAP item."""
    _, tphi = _pair((8, 8, 8))
    g2 = T.Grid((0.0, 0.0), (1.0, 1.0), (8, 8))
    phi2 = T.sample(tshapes.circle((0.5, 0.5), 0.2), g2, T.Periodic(), dtype=torch.float64,
                    device="cpu")
    vel2 = lambda xs, t: (0.0 * xs[0], 0.0 * xs[1])
    general = [
        (T.AdvectionTerm(_velf), tphi, {"hooks": True}),
        (T.AdvectionTerm(_velf), tphi, {"fast": "off"}),
        (T.AdvectionTerm(vel2), phi2, {"hooks": True}),
        (T.AdvectionTerm(_velf, "upwind"), tphi, {}),
        (_OtherTerm(), tphi, {}),
    ]
    for terms, phi, kw in general:
        eq = T.LevelSetEquation(terms=terms, ic=phi)
        assert eq._cuda_stepper(kw.get("hooks", False), kw.get("fast", "auto")) is None
    stepper = T.LevelSetEquation(terms=T.AdvectionTerm(vel2), ic=phi2)._cuda_stepper(False, "auto")
    assert isinstance(stepper, tfused.FusedStepper) and stepper.shape == (8, 8)
    eq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf, update_func=lambda v, p, t: v), ic=tphi)
    stepper = eq._cuda_stepper(False, "auto")  # update_func: the fused stepper
    assert isinstance(stepper, tfused.FusedStepper) and stepper.has_update
    assert eq._cuda_stepper(True, "auto") is None  # with hooks: the general path
    # an object that is no term kind is refused with a reason that says so;
    # a sum of two advection terms routes to the fused stepper
    assert "no term kind" in tfused.unsupported_reason((_OtherTerm(),), tphi, T.RK3())
    two = (T.AdvectionTerm(_velf), T.AdvectionTerm(_velf))
    assert tfused.unsupported_reason(two, tphi, T.RK3()) is None
    stepper = T.LevelSetEquation(terms=two, ic=tphi)._cuda_stepper(False, "auto")
    assert isinstance(stepper, tfused.FusedStepper) and len(stepper.entries) == 2
    # an Extrapolation(7) axis of 6 nodes cannot be refreshed: an error, as in
    # JAX (the general path's ValueError), not a pending port
    g = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (8, 8, 6))
    phi = T.MeshField(torch.zeros(8, 8, 6, dtype=torch.float64), g, T.Extrapolation(7))
    eq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=phi)
    assert eq._cuda_stepper(False, "auto") is None
    with pytest.raises(ValueError, match="needs 8 nodes"):
        eq.integrate(1.0, max_steps=1)
    with pytest.raises(NotImplementedError, match="integrator"):
        tfused.FusedStepper(T.AdvectionTerm(_velf), tphi, object())
    half = tphi.with_values(tphi.values.to(torch.bfloat16))
    with pytest.raises(NotImplementedError, match="float32 or float64"):
        T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=half)._cuda_stepper(False, "auto")
    assert tfused.supports_fused(T.AdvectionTerm(_velf), tphi)
    assert tfused.supports_fused(T.AdvectionTerm(vel2), phi2)
