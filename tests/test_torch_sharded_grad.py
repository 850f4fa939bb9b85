"""The port's differentiable sharded fused rollout
(``make_sharded_fused_rollout``) on the CPU in float64: each stage K1 per
shard and the sharded refresh (K9), the backward the refresh's transpose and
the stage adjoint per shard. Gradients for phi and a streamed velocity
against the port's single-device ``rollout`` and, at one case, against the
JAX package's sharded rollout (interpret mode, its 8-device CPU mesh)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.parallel.fused_evolve import make_sharded_fused_rollout as jmake_rollout
from lsm_tpu.parallel.sharding import make_mesh as jmake_mesh, shard_field as jshard_field
from lsm_tpu_torch.parallel import make_mesh, shard_field, unshard
from lsm_tpu_torch.parallel.fused_evolve import make_sharded_fused_rollout
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


def _check(gs, gr, tol=1e-11):
    a, b = gs.detach().numpy(), gr.detach().numpy()
    scale = max(np.abs(b).max(), 1.0)
    assert np.abs(b).max() > 0
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def _loss_grad(fn, x):
    x = x.detach().clone().requires_grad_()
    loss = fn(x)
    (g,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), g


def _periodic_case():
    grid = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (16, 16, 12))
    phi = T.sample(lambda X, Y, Z: torch.sin(2 * math.pi * X) * torch.cos(2 * math.pi * Y)
                   + 0.3 * torch.sin(2 * math.pi * Z), grid, T.Periodic(), device="cpu")

    def vel(xs, t):
        return (0.5 - xs[1] + 0.0 * (xs[0] + xs[2]), xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
                0.2 + 0.0 * (xs[0] + xs[1] + xs[2]))

    return grid, phi, (T.AdvectionTerm(vel),)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 1)], ids=lambda s: "x".join(map(str, s)))
def test_rollout_gradient_matches_single_device_analytic_rk3(mesh_shape):
    """A traced velocity (K1″ and K3″ at each shard's origin), the periodic
    wrap across shard faces, RK3, 3 steps."""
    grid, phi, terms = _periodic_case()
    dt = 0.3 * grid.min_spacing
    ro = make_sharded_fused_rollout(T.RK3(), _cpu_mesh(mesh_shape), grid, nsteps=3)
    vs, gs = _loss_grad(lambda v: (ro(terms, phi.with_values(v), 0.0, dt).values ** 2).sum(),
                        phi.values)
    vr, gr = _loss_grad(lambda v: (T.rollout(T.RK3(), terms, phi.with_values(v), 0.0, dt, 3)[0]
                                   .values ** 2).sum(), phi.values)
    assert abs(vs - vr) <= 1e-12 * abs(vr)
    _check(gs, gr)


def test_rollout_gradient_matches_single_device_streamed_mixed_bcs():
    """A streamed velocity, mixed BCs on the physical faces, FE, 2 steps:
    gradients for phi and for a velocity component."""
    grid = T.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (16, 16, 12))
    rng = np.random.default_rng(5)
    phi = T.sample(lambda X, Y, Z: torch.sqrt((X + 0.013) ** 2 + (Y - 0.021) ** 2 + Z ** 2)
                   - 0.493, grid, [(T.Symmetry(), T.Extrapolation(2)), T.Extrapolation(1),
                                   T.Periodic()], device="cpu")
    phi = phi.with_values(phi.values + torch.tensor(rng.standard_normal(grid.shape)) * 1e-3)
    vel = T.sample(lambda X, Y, Z: (-Y + 0.0 * (X + Z), X + 0.0 * (Y + Z),
                                    0.1 + 0.0 * (X + Y + Z)), grid, vector=True, device="cpu")
    dt = 0.3 * grid.min_spacing
    mesh = _cpu_mesh((4, 2))
    ro = make_sharded_fused_rollout(T.ForwardEuler(), mesh, grid, nsteps=2)

    def sharded(v, u0):
        u = torch.cat([u0[None], vel.values[1:]])
        return (ro((T.AdvectionTerm(vel.with_values(u)),), phi.with_values(v), 0.0, dt)
                .values ** 2).sum()

    def single(v, u0):
        u = torch.cat([u0[None], vel.values[1:]])
        out, _ = T.rollout(T.ForwardEuler(), (T.AdvectionTerm(vel.with_values(u)),),
                           phi.with_values(v), 0.0, dt, 2)
        return (out.values ** 2).sum()

    u0 = vel.values[0]
    _, gs = _loss_grad(lambda v: sharded(v, u0), phi.values)
    _, gr = _loss_grad(lambda v: single(v, u0), phi.values)
    _check(gs, gr)
    _, gs = _loss_grad(lambda u: sharded(phi.values, u), u0)
    _, gr = _loss_grad(lambda u: single(phi.values, u), u0)
    _check(gs, gr)


def test_remat_is_gradient_neutral_and_shards_come_back_sharded():
    grid, phi, terms = _periodic_case()
    mesh = _cpu_mesh((2, 2))
    dt = 0.3 * grid.min_spacing
    grads = []
    for remat in (True, False):
        ro = make_sharded_fused_rollout(T.RK2(), mesh, grid, nsteps=2, remat=remat)
        grads.append(_loss_grad(lambda v: (ro(terms, phi.with_values(v), 0.0, dt).values ** 2)
                                .sum(), phi.values)[1])
    assert torch.equal(grads[0], grads[1])
    ro = make_sharded_fused_rollout(T.RK2(), mesh, grid, nsteps=2)
    with torch.no_grad():
        out = ro(terms, shard_field(phi, mesh), 0.0, dt)
        ref = ro(terms, phi, 0.0, dt)
    assert torch.equal(unshard(out).values, ref.values)


@pytest.fixture(scope="module")
def jax_rollout_grad():
    """JAX's sharded fused rollout gradient on its 8-device mesh: streamed
    velocity, Extrapolation(1), FE, 1 step (interpret mode)."""
    grid = J.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (32, 32, 128))
    rng = np.random.default_rng(9)
    phi = J.sample(lambda X, Y, Z: jnp.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.5, grid,
                   J.Extrapolation(1))
    phi = phi.with_values(phi.values + jnp.asarray(rng.standard_normal(grid.shape)) * 1e-3)
    vel = J.sample(lambda X, Y, Z: (-Y + 0.0 * (X + Z), X + 0.0 * (Y + Z),
                                    0.1 + 0.0 * (X + Y + Z)), grid, vector=True)
    mesh = jmake_mesh(n_devices=8)
    dt = 0.3 * grid.min_spacing
    ro = jmake_rollout(J.ForwardEuler(), mesh, grid, nsteps=1, interpret=True)

    def loss(v):
        out = ro((J.AdvectionTerm(vel),), jshard_field(phi.with_values(v), mesh), 0.0, dt)
        return jnp.sum(out.values ** 2)

    val, g = jax.value_and_grad(loss)(phi.values)
    return np.array(phi.values), np.array(vel.values), float(val), np.array(g), dt


def test_rollout_gradient_matches_jax(jax_rollout_grad):
    phi0, vel0, jval, jg, dt = jax_rollout_grad
    grid = T.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (32, 32, 128))
    phi = field_from_numpy(phi0, grid, T.Extrapolation(1), device="cpu")
    vel = field_from_numpy(vel0, grid, device="cpu")
    ro = make_sharded_fused_rollout(T.ForwardEuler(), make_mesh(devices=["cpu"] * 8), grid,
                                    nsteps=1)
    val, g = _loss_grad(lambda v: (ro((T.AdvectionTerm(vel),), phi.with_values(v), 0.0, dt)
                                   .values ** 2).sum(), phi.values)
    assert abs(val - jval) <= 1e-12 * abs(jval)
    _check(g, torch.from_numpy(jg))


def test_dryrun_runs_every_sharded_path_on_a_cpu_mesh():
    from lsm_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["mesh"] == {"x": 2, "y": 2}
    assert out["dense"]["steps"] == out["band"]["steps"] == out["fused"]["steps"] == 3
    assert np.isfinite(out["train_step"]["loss"]) and out["train_step"]["grad_phi_norm"] > 0
