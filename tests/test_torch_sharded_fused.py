"""The port's fused sharded evolution (``make_sharded_evolve(fused=True)``:
K1 per shard at its global origin, the sharded refresh with the shell writer
K9, the shards' CFL bound) on the CPU in float64: against the JAX package's
fused sharded evolve (interpret mode, its 8-device CPU mesh) at one case,
and against the port's single-device fused trajectory for the cases of
``tests/test_sharded_fused.py`` at smaller shapes, on several mesh shapes;
then what the path refuses, with its reason."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.parallel import make_sharded_evolve as jmake_sharded_evolve
from lsm_tpu.parallel.sharding import make_mesh as jmake_mesh, shard_field as jshard_field
from lsm_tpu_torch.parallel import make_mesh, make_sharded_evolve, shard_field, unshard
from lsm_tpu_torch.parallel import fused_evolve as fe
from lsm_tpu_torch.utils.checkpoint import field_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread_f64():
    prev, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(prev)
    torch.set_default_dtype(dtype)


def _cpu_mesh(shape):
    return make_mesh(devices=["cpu"] * int(np.prod(shape)), mesh_shape=shape,
                     axis_names="xyz"[:len(shape)])


def _close(a, b, tol=1e-11):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1.0)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


# -- against JAX's fused sharded evolve ------------------------------------------------

JAX_SHAPE = (32, 32, 128)  # the JAX tests' smallest fused shape (its n2 % 128 rule)


@pytest.fixture(scope="module")
def jax_streamed_fe():
    """JAX's fused sharded evolve on its 8-device mesh: the streamed
    velocity, Extrapolation(1), ForwardEuler, 2 steps (interpret mode)."""
    grid = J.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), JAX_SHAPE)
    rng = np.random.default_rng(3)
    phi = J.sample(lambda X, Y, Z: jnp.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.5, grid,
                   J.Extrapolation(1))
    phi = phi.with_values(phi.values + jnp.asarray(rng.standard_normal(grid.shape)) * 1e-3)
    vel = J.sample(lambda X, Y, Z: (-Y + 0.0 * (X + Z), X + 0.0 * (Y + Z),
                                    0.1 + 0.0 * (X + Y + Z)), grid, vector=True)
    mesh = jmake_mesh(n_devices=8)
    ev = jmake_sharded_evolve(J.ForwardEuler(), mesh, grid, fused=True, max_steps=2,
                              interpret=True)
    out, t, n = ev((J.AdvectionTerm(vel),), jshard_field(phi, mesh), 0.0, 0.03)
    return (np.array(phi.values), np.array(vel.values), np.array(out.values), float(t),
            int(n), dict(mesh.shape))


def test_fused_sharded_evolve_matches_jax(jax_streamed_fe):
    phi0, vel0, jout, jt, jn, jshape = jax_streamed_fe
    grid = T.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), JAX_SHAPE)
    mesh = make_mesh(devices=["cpu"] * 8)
    assert dict(mesh.shape) == jshape
    phi = field_from_numpy(phi0, grid, T.Extrapolation(1), device="cpu")
    vel = field_from_numpy(vel0, grid, device="cpu")
    ev = make_sharded_evolve(T.ForwardEuler(), mesh, grid, fused=True, max_steps=2)
    fe.write_shell_blocks.launches = 0
    out, t, n = ev((T.AdvectionTerm(vel),), phi, 0.0, 0.03)
    assert n == jn == 2
    assert abs(t - jt) <= 1e-12 * abs(jt)
    _close(out.values.numpy(), jout)
    assert fe.write_shell_blocks.launches == 0  # the CPU runs K9's plain version


# -- against the port's single-device fused trajectory ---------------------------------


def _single_device(terms, phi, integrator, tf, max_steps):
    eq = T.LevelSetEquation(terms=terms, ic=phi, integrator=integrator)
    eq.integrate(tf, max_steps=max_steps)
    assert eq.last_fast_path == "fused"
    return eq.state.values, eq.t, eq.last_nsteps


def _check_case(terms, phi, integrator, tf, mesh_shape, max_steps=3, exact=True):
    mesh = _cpu_mesh(mesh_shape)
    assert fe.supports_sharded_fused(terms, phi, mesh)
    ev = make_sharded_evolve(integrator, mesh, phi.grid, fused=True, max_steps=max_steps)
    out, t, n = ev(terms, phi, 0.0, tf)
    ref, t_ref, n_ref = _single_device(terms, phi, integrator, tf, max_steps)
    assert n == n_ref and abs(t - t_ref) <= 1e-12 * abs(t_ref)
    if exact:  # the same arithmetic per node: bit for bit
        assert t == t_ref and torch.equal(out.values, ref)
    _close(out.values.numpy(), ref.numpy())
    return out


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 1), (1, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_analytic_periodic_rk3_matches_single_device(mesh_shape):
    """A callable velocity (traced, K1″'s program route) at each shard's
    global coordinates; the periodic wrap across shard faces."""
    grid = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (16, 16, 20))
    phi = T.sample(lambda X, Y, Z: torch.sin(2 * math.pi * X) * torch.cos(2 * math.pi * Y)
                   + 0.3 * torch.sin(2 * math.pi * Z), grid, T.Periodic(), device="cpu")

    def vel(xs, t):
        return (0.5 - xs[1] + 0.0 * (xs[0] + xs[2]), xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
                0.2 + 0.0 * (xs[0] + xs[1] + xs[2]))

    _check_case((T.AdvectionTerm(vel),), phi, T.RK3(), 0.05, mesh_shape)


def test_streamed_extrapolation_fe_matches_single_device():
    """Streamed velocity split alongside phi; Extrapolation on the physical
    faces of the outermost shards; a callable that does not trace (the
    stream route) beside it, evaluated at each shard's node coordinates."""
    grid = T.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (16, 24, 12))
    phi = T.sample(lambda X, Y, Z: torch.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.5, grid,
                   T.Extrapolation(1), device="cpu")
    vel = T.sample(lambda X, Y, Z: (-Y + 0.0 * (X + Z), X + 0.0 * (Y + Z),
                                    0.1 + 0.0 * (X + Y + Z)), grid, vector=True, device="cpu")

    def speed(xs, t):  # torch.hypot does not trace: the stream route
        return 0.05 * torch.hypot(xs[0], xs[1]) + 0.0 * xs[2]

    terms = (T.AdvectionTerm(vel), T.NormalMotionTerm(speed))
    # not bit for bit: torch's CPU hypot rounds the vectorised bulk of a
    # tensor and its scalar tail differently in the last bit, and a shard's
    # tensors have other shapes (one node of this case moves by an ulp)
    _check_case(terms, phi, T.ForwardEuler(), 0.03, (4, 2), exact=False)


def test_mixed_bcs_multi_term_rk2_matches_single_device():
    """Mixed BC kinds per dimension and a two-term Hamiltonian (advection +
    frozen-sign eikonal reinitialization), RK2, on a (4, 2) mesh."""
    grid = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (16, 16, 14))
    phi = T.sample(lambda X, Y, Z: torch.sqrt((X - 0.5) ** 2 + (Y - 0.4) ** 2 + (Z - 0.6) ** 2)
                   - 0.25, grid, [(T.Symmetry(), T.Extrapolation(2)), T.Extrapolation(1),
                                  T.Symmetry()], device="cpu")

    def vel(xs, t):
        return (0.5 - xs[1] + 0.0 * (xs[0] + xs[2]), xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
                0.0 * (xs[0] + xs[1] + xs[2]))

    terms = (T.AdvectionTerm(vel), T.EikonalReinitializationTerm.from_initial(phi))
    out = _check_case(terms, phi, T.RK2(), 0.05, (4, 2), max_steps=4)
    # a ShardedField goes in and comes out as one
    mesh = _cpu_mesh((4, 2))
    ev = make_sharded_evolve(T.RK2(), mesh, grid, fused=True, max_steps=4)
    sout, _, _ = ev(terms, shard_field(phi, mesh), 0.0, 0.05)
    assert torch.equal(unshard(sout).values, out.values)


# -- what the path refuses ---------------------------------------------------------------


def _sphere(shape, bc):
    grid = T.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), shape)
    return T.sample(lambda X, Y, Z: torch.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.5, grid, bc,
                    device="cpu")


def test_a_mesh_that_splits_dimension_2_is_refused():
    """JAX's fused driver splits dims 0 and 1 while its leaf spec splits dim 2
    over a third mesh axis (and fails in its while loop); the port refuses
    it up front, naming the reason."""
    phi = _sphere((8, 8, 16), T.Periodic())
    mesh = _cpu_mesh((2, 2, 2))
    with pytest.raises(ValueError, match="would split dimension 2"):
        make_sharded_evolve(T.RK3(), mesh, phi.grid, fused=True)
    assert not fe.supports_sharded_fused((T.AdvectionTerm(lambda xs, t: xs),), phi, mesh)
    # a third axis of size 1 is fine
    assert fe.sharded_fused_reason((T.AdvectionTerm(lambda xs, t: xs),), phi,
                                   _cpu_mesh((2, 2, 1))) is None


@pytest.mark.parametrize("case", ["update_func", "band", "local_shape", "uneven", "2d",
                                  "integrator"])
def test_what_the_fused_sharded_path_cannot_take_raises_with_its_reason(case):
    mesh = _cpu_mesh((4, 2))
    vel = T.AdvectionTerm(lambda xs, t: (1.0 + 0 * xs[0], 0 * xs[1], 0 * xs[2]))
    phi = _sphere((16, 8, 8), T.Extrapolation(2))
    if case == "update_func":
        term = T.AdvectionTerm(vel.velocity, update_func=lambda u, p, t: u)
        ev = make_sharded_evolve(T.RK3(), mesh, phi.grid, fused=True)
        with pytest.raises(ValueError, match="update_func"):
            ev((term,), phi, 0.0, 0.1)
    elif case == "band":
        with pytest.raises(ValueError, match="dense-only"):
            make_sharded_evolve(T.RK3(), mesh, phi.grid, fused=True, is_band=True)
        nb = T.NarrowBandField.from_field(phi)
        assert "dense-only" in fe.sharded_fused_reason((vel,), nb, mesh)
    elif case == "local_shape":  # Extrapolation(5) reads 6 nodes; a shard holds 4 along axis 1
        phi = _sphere((16, 8, 8), T.Extrapolation(5))
        reason = fe.sharded_fused_reason((vel,), phi, mesh)
        assert "local shape (4, 4, 8)" in reason and "Extrapolation(5)" in reason
        ev = make_sharded_evolve(T.RK3(), mesh, phi.grid, fused=True)
        with pytest.raises(ValueError, match="Extrapolation"):
            ev((vel,), phi, 0.0, 0.1)
    elif case == "uneven":
        phi = _sphere((18, 8, 8), T.Extrapolation(2))
        with pytest.raises(ValueError, match="does not split over 4 shards"):
            make_sharded_evolve(T.RK3(), mesh, phi.grid, fused=True)
    elif case == "2d":
        grid = T.Grid((0.0, 0.0), (1.0, 1.0), (16, 16))
        with pytest.raises(ValueError, match="3D only"):
            make_sharded_evolve(T.RK3(), mesh, grid, fused=True)
    else:
        from lsm_tpu_torch.integrators.explicit import TimeIntegrator

        with pytest.raises(ValueError, match="unsupported integrator"):
            fe.make_sharded_fused_evolve(TimeIntegrator(), mesh, phi.grid)
