"""``SemiImplicitI2OE`` of the port against the JAX package on the CPU, in
float64 at small seeded sizes: one step and a short ``integrate`` in 1D, 2D
and 3D under Periodic, Neumann and LinearExtrapolation, with the BiCGStab
iteration counts equal (JAX's counted by a callback on its solver's loop);
the setup errors; float32 without a warning and a solve cut short with one;
the gradient through a step against ``jax.grad`` of JAX's; and the
``ShardedField`` refusal.
"""

import warnings

import jax
import jax._src.scipy.sparse.linalg as jlin
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu_torch.integrators.semi_implicit import bicgstab
from lsm_tpu_torch.parallel import make_mesh, shard_field


class _CountingLax:
    """``jax._src.lax`` with ``while_loop`` recording the final iteration
    count of each loop it runs (BiCGStab's is the carry's last entry)."""

    def __init__(self, lax, seen):
        self._lax, self._seen = lax, seen

    def __getattr__(self, name):
        return getattr(self._lax, name)

    def while_loop(self, cond, body, init):
        out = self._lax.while_loop(cond, body, init)
        jax.debug.callback(lambda k: self._seen.append(int(k)), out[-1])
        return out


@pytest.fixture
def jax_counts(monkeypatch):
    seen = []
    monkeypatch.setattr(jlin, "lax", _CountingLax(jlin.lax, seen))
    return seen


BCS = {"periodic": ("Periodic",), "neumann": ("Neumann",), "linear": ("LinearExtrapolation",),
       "mixed": (("Periodic",), ("Neumann", "LinearExtrapolation"), ("LinearExtrapolation",))}
SHAPES = {1: (33,), 2: (20, 24), 3: (10, 12, 14)}


def _bc(m, spec, ndim):
    make = lambda name: getattr(m, name)()
    if isinstance(spec[0], str):
        return make(spec[0])
    pairs = [tuple(make(n) for n in (s if len(s) == 2 else s * 2)) for s in spec[:ndim]]
    return pairs


def _case(ndim, bc, dtype=np.float64, seed=0):
    """The same circle / sphere (plus noise) and a swirling velocity sampled
    from numpy in both packages."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[ndim]
    lo, hi = (-1.0,) * ndim, (1.0,) * ndim
    axes = [np.linspace(a, b, n) for a, b, n in zip(lo, hi, shape)]
    xs = np.meshgrid(*axes, indexing="ij")
    phi = np.sqrt(sum(x ** 2 for x in xs)) - 0.5 + 0.01 * rng.standard_normal(shape)
    if ndim == 1:
        vel = np.stack([0.7 + 0.3 * np.sin(np.pi * xs[0])])
    else:
        comps = [-xs[1], xs[0]] + [0.3 + 0.0 * xs[0]] * (ndim - 2)
        vel = np.stack(comps) + 0.05 * rng.standard_normal((ndim,) + shape)
    phi, vel = phi.astype(dtype), vel.astype(dtype)
    jgrid, tgrid = J.Grid(lo, hi, shape), T.Grid(lo, hi, shape)
    jphi = J.MeshField(jnp.asarray(phi), jgrid, _bc(J, BCS[bc], ndim))
    tphi = T.MeshField(torch.from_numpy(phi), tgrid, _bc(T, BCS[bc], ndim))
    jvel = J.MeshField(jnp.asarray(vel), jgrid)
    tvel = T.MeshField(torch.from_numpy(vel), tgrid)
    return jphi, tphi, jvel, tvel


def _close(got, want, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("bc", list(BCS))
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_one_step_matches_jax(ndim, bc, jax_counts):
    jphi, tphi, jvel, tvel = _case(ndim, bc)
    dt = 1.5 * min(tphi.spacing)  # CFL ~ 1.5: the implicit part matters
    ji, ti = J.SemiImplicitI2OE(), T.SemiImplicitI2OE()
    jout, _ = ji.advance((J.AdvectionTerm(jvel),), jphi, 0.0, dt)
    tout, _ = ti.advance((T.AdvectionTerm(tvel),), tphi, 0.0, dt)
    _close(tout.values, jout.values)
    assert jax_counts == [ti.last_solve["iterations"]] and jax_counts[0] > 1
    assert ti.last_solve["rel_residual"] <= 10 * ti.last_solve["tol"]


@pytest.mark.parametrize("ndim,bc", [(1, "linear"), (2, "periodic"), (3, "mixed")])
def test_integrate_matches_jax(ndim, bc, jax_counts):
    """A few adaptive steps of ``integrate`` (the general path): every step's
    state within 1e-10 max|phi| and its iteration count equal."""
    jphi, tphi, jvel, tvel = _case(ndim, bc, seed=1)
    tf = 6.0 * min(tphi.spacing)
    jstates, tstates, titers = [], [], []
    jeq = J.LevelSetEquation(terms=J.AdvectionTerm(jvel), ic=jphi,
                             integrator=J.SemiImplicitI2OE())
    jeq.integrate(tf, posthook=lambda e: jstates.append(np.asarray(e.state.values)))
    teq = T.LevelSetEquation(terms=T.AdvectionTerm(tvel), ic=tphi,
                             integrator=T.SemiImplicitI2OE())
    teq.integrate(tf, posthook=lambda e: (tstates.append(e.state.values.clone()),
                                          titers.append(e.integrator.last_solve["iterations"])))
    assert teq.last_fast_path is None and teq.t == jeq.t == tf
    assert len(tstates) == len(jstates) >= 3 and jax_counts == titers
    for got, want in zip(tstates, jstates):
        _close(got, want)


def test_setup_errors():
    _, tphi, _, tvel = _case(2, "periodic")
    si, adv = T.SemiImplicitI2OE(), T.AdvectionTerm(tvel)
    bad = [((adv, adv), tphi, "exactly one AdvectionTerm"),
           ((T.CurvatureTerm(0.1),), tphi, "exactly one AdvectionTerm"),
           ((adv,), T.NarrowBandField.from_field(tphi.with_bcs(T.Neumann(), replace=True)),
            "narrow band"),
           ((adv,), tphi.with_bcs(T.Symmetry(), replace=True), "not supported"),
           ((adv,), tphi.with_bcs(T.Extrapolation(2), replace=True), "not supported")]
    for terms, phi, msg in bad:
        with pytest.raises(ValueError, match=msg):
            si.advance(terms, phi, 0.0, 0.01)
    thin = T.MeshField(torch.zeros(2, 5, dtype=torch.float64),
                       T.Grid((0.0, 0.0), (1.0, 1.0), (2, 5)), T.Periodic())
    with pytest.raises(ValueError, match="at least 3"):
        si.advance((T.AdvectionTerm(lambda xs, t: (1.0, 0.0)),), thin, 0.0, 0.01)


def test_float32_converges_without_a_warning(jax_counts):
    jphi, tphi, jvel, tvel = _case(3, "periodic", dtype=np.float32, seed=2)
    dt = 1.5 * min(tphi.spacing)
    ti = T.SemiImplicitI2OE()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, _ = ti.advance((T.AdvectionTerm(tvel),), tphi, 0.0, dt)
    assert out.values.dtype == torch.float32
    assert ti.last_solve["tol"] == 50.0 * float(np.finfo(np.float32).eps)
    assert ti.last_solve["rel_residual"] <= 10 * ti.last_solve["tol"]
    jout, _ = J.SemiImplicitI2OE().advance((J.AdvectionTerm(jvel),), jphi, 0.0, dt)
    _close(out.values, jout.values, tol=1e-5)


def test_a_solve_cut_short_warns():
    _, tphi, _, tvel = _case(2, "neumann", seed=3)
    ti = T.SemiImplicitI2OE(maxiter=1)
    with pytest.warns(UserWarning, match="BiCGStab did not converge"):
        ti.advance((T.AdvectionTerm(tvel),), tphi, 0.0, 3.0 * min(tphi.spacing))
    assert ti.last_solve["iterations"] == 1
    quiet = T.SemiImplicitI2OE(maxiter=1, check_convergence=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet.advance((T.AdvectionTerm(tvel),), tphi, 0.0, 3.0 * min(tphi.spacing))
    assert quiet.last_solve["rel_residual"] is None


@pytest.mark.parametrize("ndim,bc", [(2, "mixed"), (3, "linear")])
def test_gradient_matches_jax_grad(ndim, bc):
    """d/d(phi, velocity, dt) of ``sum(w * step(phi))`` through one step:
    the port's adjoint solve against ``jax.grad`` (custom_linear_solve)."""
    jphi, tphi, jvel, tvel = _case(ndim, bc, seed=4)
    dt0 = 1.5 * min(tphi.spacing)
    w = np.random.default_rng(5).standard_normal(SHAPES[ndim])

    def jloss(v, u, dt):
        out, _ = J.SemiImplicitI2OE().advance(
            (J.AdvectionTerm(J.MeshField(u, jvel.grid)),), jphi.with_values(v), 0.0, dt)
        return jnp.sum(out.values * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jphi.values, jvel.values, dt0)
    v = tphi.values.clone().requires_grad_()
    u = tvel.values.clone().requires_grad_()
    dt = torch.tensor(dt0, dtype=torch.float64, requires_grad=True)
    out, _ = T.SemiImplicitI2OE().advance((T.AdvectionTerm(T.MeshField(u, tvel.grid)),),
                                          tphi.with_values(v), 0.0, dt)
    tg = torch.autograd.grad((out.values * torch.from_numpy(w)).sum(), (v, u, dt))
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        assert np.abs(a.detach().numpy() - b).max() <= 1e-8 * max(np.abs(b).max(), 1e-300)


def test_bicgstab_solves_a_nonsymmetric_system():
    """The solver alone on a small dense nonsymmetric system, its Jacobi
    preconditioner and its breakdown code on a zero right-hand side's
    exact start."""
    rng = np.random.default_rng(6)
    A = torch.from_numpy(np.eye(40) * 4 + rng.standard_normal((40, 40)) * 0.3)
    b = torch.from_numpy(rng.standard_normal(40))
    inv = 1.0 / torch.diagonal(A)
    x, k = bicgstab(lambda v: A @ v, b, torch.zeros(40, dtype=torch.float64), 1e-12, 200,
                    lambda v: v * inv)
    assert 0 < k < 200
    torch.testing.assert_close(A @ x, b, rtol=0, atol=1e-10)
    x, k = bicgstab(lambda v: A @ v, b, torch.linalg.solve(A, b), 0.0, 5)
    assert k in (-10, -11, 5)


def test_sharded_field_is_refused():
    _, tphi, _, tvel = _case(3, "periodic")
    mesh = make_mesh(devices=["cpu"] * 2, mesh_shape=(2,), axis_names="x")
    sharded = shard_field(tphi, mesh)
    with pytest.raises(TypeError, match="ShardedField"):
        T.SemiImplicitI2OE().advance((T.AdvectionTerm(tvel),), sharded, 0.0, 0.01)
