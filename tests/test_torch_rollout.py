"""Gradients of the port's ``rollout`` against ``jax.grad`` of the JAX
package's, on the CPU in float64, plus the port's own drivers: remat,
``evolve``, the device default and the CUDA route's errors.

On the CPU the fused stepper runs the kernels' plain versions forward and
backward (K3/K4/K5's plain versions through ``fused_step_stage``), so these
tests drive the same autograd graph the card runs. Inputs are made with numpy
from a seed and handed to both packages.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu_torch.integrators.fused import FusedStepper, gradient_reason
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.ops import weno_v2 as tv2
from lsm_tpu_torch.ops import weno_v2_bwd as tbwd
from lsm_tpu_torch.utils import checkpoint as tckpt
from test_torch_dense_2d import _CudaTyped


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _velf(xs, t):
    # rigid rotation about the z axis plus a time-dependent drift along z;
    # u1 is exactly 0 on the plane x = 0.5 (tie cells); jnp and torch alike
    return (
        0.5 - xs[1] + 0.0 * (xs[0] + xs[2]),
        xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
        0.1 + 0.5 * t + 0.0 * (xs[0] + xs[1] + xs[2]),
    )


def _fields(shape, seed, bc="Periodic"):
    """A perturbed sphere and a random streamed velocity, for both packages."""
    rng = np.random.default_rng(seed)
    args = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape)
    jg, tg = J.Grid(*args), T.Grid(*args)
    base = _np(T.sample(tshapes.sphere((0.5, 0.45, 0.55), 0.3), tg, device="cpu",
                        dtype=torch.float64).values)
    vals = base + 1e-3 * rng.standard_normal(shape)
    vel = 0.5 * rng.standard_normal((3, *shape))
    jphi = J.MeshField(jnp.asarray(vals), jg, getattr(J, bc)())
    tphi = T.MeshField(torch.from_numpy(vals), tg, getattr(T, bc)())
    return jg, tg, jphi, tphi, vel


INTEGRATORS = ["ForwardEuler", "RK2", "RK3"]


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_rollout_gradient_matches_jax(integrator):
    """Loss ``sum(phi_final^2)`` after 3 steps: gradients w.r.t. the values
    and the streamed velocity, through the port's fused stepper and its
    general path, against JAX's general path."""
    shape = (12, 16, 20)
    jg, tg, jphi, tphi, vel = _fields(shape, seed=INTEGRATORS.index(integrator))
    dt = 0.3 * jg.min_spacing

    def jloss(v, u):
        term = J.AdvectionTerm(J.MeshField(u, jg))
        out, _ = J.rollout(getattr(J, integrator)(), (term,), jphi.with_values(v), 0.0, dt, 3,
                           fast="off")
        return jnp.sum(out.values ** 2)

    jv, (jgv, jgu) = jax.value_and_grad(jloss, argnums=(0, 1))(jphi.values, jnp.asarray(vel))
    for fast in ("auto", "off"):
        v = tphi.values.clone().requires_grad_()
        u = torch.from_numpy(vel).requires_grad_()
        term = T.AdvectionTerm(T.MeshField(u, tg))
        out, _ = T.rollout(getattr(T, integrator)(), (term,), tphi.with_values(v), 0.0, dt, 3,
                           fast=fast)
        loss = (out.values ** 2).sum()
        gv, gu = torch.autograd.grad(loss, (v, u))
        assert abs(loss.item() - float(jv)) <= 1e-12 * abs(float(jv))
        assert _rel(gv, jgv) < 1e-10, fast
        assert _rel(gu, jgu) < 1e-10, fast


def test_rollout_gradient_matches_jax_fused_interpret():
    """One RK3 case against JAX's fused Pallas path (interpret mode): forward
    K1 + K2 and the Pallas backward, the path the JAX bench times."""
    shape = (16, 16, 128)
    jg, tg, jphi, tphi, _ = _fields(shape, seed=5)
    dt = 0.3 * jg.min_spacing

    def jloss(v):
        out, _ = J.rollout(J.RK3(), (J.AdvectionTerm(_velf),), jphi.with_values(v), 0.0, dt,
                           1, fast="interpret")
        return jnp.sum(out.values ** 2)

    jgv = jax.grad(jloss)(jphi.values)
    v = tphi.values.clone().requires_grad_()
    out, _ = T.rollout(T.RK3(), (T.AdvectionTerm(_velf),), tphi.with_values(v), 0.0, dt, 1)
    (gv,) = torch.autograd.grad((out.values ** 2).sum(), v)
    assert _rel(gv, jgv) < 1e-10


def test_rollout_remat_is_gradient_neutral():
    """``remat`` and ``remat_chunk`` change when the stages are recomputed,
    never what is computed; a chunk of 2 over 5 steps leaves a remainder."""
    shape = (10, 12, 14)
    _, tg, _, tphi, vel = _fields(shape, seed=11)
    dt = 0.3 * tg.min_spacing
    term = T.AdvectionTerm(T.MeshField(torch.from_numpy(vel), tg))
    grads = []
    for remat, chunk in ((False, None), (True, None), (True, 2)):
        v = tphi.values.clone().requires_grad_()
        out, _ = T.rollout(T.RK3(), (term,), tphi.with_values(v), 0.0, dt, 5, remat=remat,
                           remat_chunk=chunk)
        grads.append(torch.autograd.grad((out.values ** 2).sum(), v)[0])
    scale = float(grads[0].abs().max())
    assert scale > 0
    for g in grads[1:]:
        assert float((g - grads[0]).abs().max()) <= 1e-12 * scale


def test_rollout_time_gradients_match_jax():
    """d loss / d dt and d loss / d t0 with a time-dependent callable
    velocity, through the stage coefficients and the callable's own graph,
    on the fused stepper and on the general path."""
    shape = (12, 14, 16)
    jg, tg, jphi, tphi, _ = _fields(shape, seed=21, bc="LinearExtrapolation")
    dt0, t00 = 0.25 * jg.min_spacing, 0.2

    def jloss(t0, dt):
        out, _ = J.rollout(J.RK3(), (J.AdvectionTerm(_velf),), jphi, t0, dt, 3, fast="off")
        return jnp.sum(out.values ** 2)

    jd0, jddt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(t00), jnp.asarray(dt0))
    for fast in ("auto", "off"):
        t0 = torch.tensor(t00, dtype=torch.float64, requires_grad=True)
        dt = torch.tensor(dt0, dtype=torch.float64, requires_grad=True)
        out, _ = T.rollout(T.RK3(), (T.AdvectionTerm(_velf),), tphi, t0, dt, 3, fast=fast)
        d0, ddt = torch.autograd.grad((out.values ** 2).sum(), (t0, dt))
        assert abs(float(ddt) - float(jddt)) <= 1e-10 * abs(float(jddt)), fast
        assert abs(float(d0) - float(jd0)) <= 1e-10 * abs(float(jd0)), fast


def test_gradient_flows_through_the_integrate_stepper():
    """The stepper ``integrate`` runs builds a graph when its input requires
    grad and keeps none when it does not; on the CPU nothing launches."""
    shape = (10, 12, 14)
    _, tg, _, tphi, vel = _fields(shape, seed=31)
    term = T.AdvectionTerm(T.MeshField(torch.from_numpy(vel), tg))
    stepper = FusedStepper((term,), tphi, T.RK3())
    P = stepper.pack(tphi.values)
    assert stepper.step(P, 0.0, 1e-3).grad_fn is None
    v = tphi.values.clone().requires_grad_()
    out = stepper.step(stepper.pack(v), 0.0, 1e-3)
    assert out.grad_fn is not None
    (g,) = torch.autograd.grad((stepper.unpack(out) ** 2).sum(), v)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert tv2.fused_stage.launches == tv2.refresh_ghosts_fast.launches == 0
    assert tbwd.stage_backward.launches == tbwd.fold_ghost_cotangent_fast.launches == 0
    assert tbwd.zero_pad_shells.launches == 0


def test_rollout_and_sample_take_jax_positional_order():
    """``rollout(integrator, terms, phi, t0, dt, nsteps, unroll, fast, remat,
    remat_chunk)`` and ``sample(fn, grid, bc, dtype, vector)`` as JAX has
    them (``sample``'s ``device`` last): both packages called positionally
    with the same arguments agree, and ``unroll`` is accepted."""
    names = lambda f: list(inspect.signature(f).parameters)
    assert names(T.rollout) == names(J.rollout)
    assert names(T.sample) == names(J.sample) + ["device"]
    shape = (10, 12, 14)
    _, _, jphi, tphi, _ = _fields(shape, seed=13)
    dt = 0.2 * jphi.grid.min_spacing
    jout, _ = J.rollout(J.RK3(), (J.AdvectionTerm(_velf),), jphi, 0.0, dt, 2, 2, "off", True, 1)
    for args in ((2, "off", True, 1), (2, "auto", False, None), (1, "off", False, None)):
        tout, _ = T.rollout(T.RK3(), (T.AdvectionTerm(_velf),), tphi, 0.0, dt, 2, *args)
        assert _rel(tout.values, jout.values) < 1e-12
    grid = T.Grid((0.0, 0.0), (1.0, 1.0), (6, 7))
    vec = T.sample(lambda x, y: (x + 0.0 * y, y + 0.0 * x), grid, None, torch.float64, True,
                   "cpu")
    jvec = J.sample(lambda x, y: (x + 0.0 * y, y + 0.0 * x), J.Grid(*((0.0, 0.0), (1.0, 1.0),
                                                                     (6, 7))), None,
                    jnp.float64, True)
    assert vec.is_vector and vec.values.dtype == torch.float64
    assert _rel(vec.values, jvec.values) < 1e-15


def test_evolve_matches_jax():
    shape = (10, 12, 14)
    jg, tg, jphi, tphi, _ = _fields(shape, seed=41)
    jout, _, jt, jn = J.evolve(J.RK3(), (J.AdvectionTerm(_velf),), jphi, 0.0, 0.05)
    tout, terms, t, n = T.evolve(T.RK3(), (T.AdvectionTerm(_velf),), tphi, 0.0, 0.05)
    assert (t, n) == (float(jt), int(jn)) and n >= 2 and len(terms) == 1
    assert _rel(tout.values, jout.values) < 1e-10
    _, _, t1, n1 = T.evolve(T.RK3(), (T.AdvectionTerm(_velf),), tphi, 0.0, 0.05, max_steps=1)
    assert n1 == 1 and t1 < 0.05


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """With no device the entry points ask for the card; without one they
    raise and say how to ask for the CPU, never falling back to it."""
    g = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (4, 5, 6))
    phi = tckpt.field_from_numpy(np.ones((4, 5, 6)), g, T.Periodic(), device="cpu")
    path = tckpt.save_checkpoint(tmp_path / "c.npz", phi)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: T.sample(tshapes.zalesak_sphere(), g), lambda: g.coords(),
             lambda: g.axis_coords(1),
             lambda: tckpt.field_from_numpy(np.zeros((4, 5, 6)), g),
             lambda: tckpt.load_checkpoint(path)]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert T.sample(tshapes.zalesak_sphere(), g, device="cpu").values.device.type == "cpu"


def test_rollout_general_path_raises_on_cuda():
    """The CUDA route of ``rollout``: ``fast="off"`` and the upwind scheme
    run the general path (here on the plain versions, the tensors lying on
    the CPU), ``update_func`` the fused stepper, and a gradient through the
    dense 2D stepper runs (the 2D entries of K4, K3 and K5, here their plain
    versions), equal to the CPU's."""
    shape = (6, 7, 8)
    _, tg, _, tphi, _ = _fields(shape, seed=51)
    phi = tphi.with_values(tphi.values.as_subclass(_CudaTyped))
    assert phi.values.is_cuda
    off, _ = T.rollout(T.RK3(), (T.AdvectionTerm(_velf),), phi, 0.0, 1e-3, 1, fast="off")
    ref, _ = T.rollout(T.RK3(), (T.AdvectionTerm(_velf),), tphi, 0.0, 1e-3, 1)
    torch.testing.assert_close(off.values.as_subclass(torch.Tensor), ref.values, rtol=0,
                               atol=1e-13)
    up, _ = T.rollout(T.RK3(), (T.AdvectionTerm(_velf, "upwind"),), phi, 0.0, 1e-3, 1)
    assert bool(torch.isfinite(up.values).all())
    seen = []
    upd = T.AdvectionTerm(_velf, update_func=lambda v, p, t: seen.append(t) or v)
    out, (term,) = T.rollout(T.RK3(), (upd,), phi, 0.0, 1e-3, 1)
    torch.testing.assert_close(out.values.as_subclass(torch.Tensor), ref.values, rtol=0,
                               atol=1e-13)
    assert len(seen) == 3 and term.update_func is upd.update_func  # one refresh per stage
    g2 = T.Grid((0.0, 0.0), (1.0, 1.0), (8, 9))
    phi2 = T.sample(tshapes.circle((0.5, 0.5), 0.2), g2, T.Periodic(), dtype=torch.float64,
                    device="cpu")
    v2 = phi2.values.clone().as_subclass(_CudaTyped).requires_grad_()
    vel2 = lambda xs, t: (0.5 - xs[1] + 0.0 * xs[0], xs[0] - 0.5 + 0.0 * xs[1])
    assert gradient_reason((T.AdvectionTerm(vel2),), phi2) is None
    grads = []
    for v in (v2, phi2.values.clone().requires_grad_()):
        out, _ = T.rollout(T.RK3(), (T.AdvectionTerm(vel2),), phi2.with_values(v), 0.0, 1e-3, 1)
        grads.append(torch.autograd.grad((out.values ** 2).sum(), v)[0])
    assert torch.equal(grads[0].as_subclass(torch.Tensor), grads[1])
    with pytest.raises(ValueError, match="fast must be"):
        T.rollout(T.RK3(), (T.AdvectionTerm(_velf),), tphi, 0.0, 1e-3, 1, fast="interpret")
