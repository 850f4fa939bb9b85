"""Gradients through the port's narrow-band stepper, on the CPU in float64:
one step of ``FusedBandStepper`` (the plain versions of K6, K7 and K8 forward,
autograd of the plain band composite backward) against ``jax.grad`` of the
JAX package's ``FusedBandStepper`` in interpret mode and against the port's
dense band path; a streamed speed's gradient; a band ``rollout`` with and
without remat.

The setup mirrors ``tests/test_fused_autodiff.py`` (a slightly off-centre
sphere with a little noise, so that no exact upwind or minmod tie makes the
two formulations pick different subgradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.core.field import MeshField as JMF
from lsm_tpu.core.narrowband import NarrowBandField as JNB
from lsm_tpu.integrators.band_fused import FusedBandStepper as JStepper
from lsm_tpu.integrators.fused import _term_spec
from lsm_tpu_torch.core.narrowband import NarrowBandField as TNB
from lsm_tpu_torch.integrators import loop as tloop
from lsm_tpu_torch.integrators.band_fused import FusedBandStepper as TStepper
from lsm_tpu_torch.ops import band as bd

INTEG = {"fe": (J.ForwardEuler, T.ForwardEuler), "rk2": (J.RK2, T.RK2),
         "rk3": (J.RK3, T.RK3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _setup(shape=(16, 16, 128)):
    """``(jgrid, tgrid, jbcs, tbcs, phi_values, speed)``: the test_fused_autodiff
    sphere, noise and speed, as numpy."""
    args = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), shape)
    jg, tg = J.Grid(*args), T.Grid(*args)
    rng = np.random.default_rng(7)
    base = J.sample(lambda X, Y, Z: jnp.sqrt((X + 0.013) ** 2 + (Y - 0.021) ** 2
                                              + (Z + 0.007) ** 2) - 0.493,
                    jg, J.Extrapolation(1))
    phi = np.asarray(base.values) + rng.standard_normal(shape) * 1e-3
    speed = 0.1 + 0.01 * rng.standard_normal(shape)
    return jg, tg, base.bcs, T.normalize_bcs(T.Extrapolation(1), 3), phi, speed


def _port_step_loss(integrator, tg, tb, dt, phi, speed):
    """``sum(phi^2)`` after one step of the port's band stepper (re-tubed)."""
    nb = TNB(phi, tg, tb, nlayers=3, _normalized=True)
    term = T.NormalMotionTerm(T.MeshField(speed, tg, tb, _normalized=True))
    stepper = TStepper((term,), nb, integrator)
    state = stepper.step(stepper.pack(nb), 0.0, dt)
    return (stepper.unpack(state, check=False).values ** 2).sum()


def _port_dense_loss(integrator, tg, tb, dt, phi, speed):
    """The same loss through the port's dense band path (the general step,
    then the re-tube)."""
    nb = TNB(phi, tg, tb, nlayers=3, _normalized=True)
    term = T.NormalMotionTerm(T.MeshField(speed, tg, tb, _normalized=True))
    out, _ = tloop.step(integrator, (term,), nb, 0.0, dt)
    return (out.update_band().values ** 2).sum()


@pytest.mark.parametrize("name", list(INTEG))
def test_band_stepper_gradient_matches_jax_and_the_dense_band_path(name):
    jg, tg, jb, tb, phi, speed = _setup()
    jint, tint = INTEG[name][0](), INTEG[name][1]()
    dt = 0.3 * jg.min_spacing
    nb0 = JNB(jnp.asarray(phi), jg, jb, nlayers=3, _normalized=True)
    jterm = J.NormalMotionTerm(JMF(jnp.asarray(speed), jg, jb, _normalized=True))
    jstepper = JStepper((jterm,), nb0, jint, interpret=True)

    def jloss(v):
        nb = JNB(v, jg, jb, nlayers=3, _normalized=True)
        state = jstepper._step_impl(jstepper.pack(nb), 0.0 * dt, jnp.asarray(dt))
        return jnp.sum(jstepper.unpack(state).values ** 2)

    jl, jgrad = jax.value_and_grad(jloss)(jnp.asarray(phi))
    v = torch.from_numpy(phi).requires_grad_()
    s = torch.from_numpy(speed)
    loss = _port_step_loss(tint, tg, tb, dt, v, s)
    (grad,) = torch.autograd.grad(loss, v)
    assert bd.band_stage.launches == bd.refresh_band_ghosts_fast.launches == 0
    assert abs(float(loss.detach()) - float(jl)) <= 1e-12 * abs(float(jl))
    assert _err(grad, jgrad) <= 1e-12
    w = torch.from_numpy(phi).requires_grad_()
    (dense,) = torch.autograd.grad(_port_dense_loss(tint, tg, tb, dt, w, s), w)
    assert _err(grad, dense) <= 1e-12


def test_band_stepper_streamed_speed_gradient():
    """The gradient reaches a streamed speed through the tile-packed gather
    (RK2, as the JAX package's own test): against JAX's band stepper and the
    port's dense band path, and nonzero."""
    jg, tg, jb, tb, phi, speed = _setup()
    dt = 0.3 * jg.min_spacing
    nb0 = JNB(jnp.asarray(phi), jg, jb, nlayers=3, _normalized=True)
    term0 = J.NormalMotionTerm(JMF(jnp.asarray(speed), jg, jb, _normalized=True))
    jstepper = JStepper((term0,), nb0, J.RK2(), interpret=True)

    def jloss(sp):
        term = J.NormalMotionTerm(JMF(sp, jg, jb, _normalized=True))
        jstepper.specs = (_term_spec(term, nb0),)
        state = jstepper._step_impl(jstepper.pack(nb0), 0.0 * dt, jnp.asarray(dt))
        return jnp.sum(jstepper.unpack(state).values ** 2)

    jgrad = jax.grad(jloss)(jnp.asarray(speed))
    v = torch.from_numpy(phi)
    s = torch.from_numpy(speed).requires_grad_()
    (grad,) = torch.autograd.grad(_port_step_loss(T.RK2(), tg, tb, dt, v, s), s)
    assert float(grad.abs().max()) > 0
    assert _err(grad, jgrad) <= 1e-12
    s2 = torch.from_numpy(speed).requires_grad_()
    (dense,) = torch.autograd.grad(_port_dense_loss(T.RK2(), tg, tb, dt, v, s2), s2)
    assert _err(grad, dense) <= 1e-12


def test_band_rollout_remat_is_gradient_neutral():
    """A 2-step band rollout through the band stepper (curvature and a
    streamed normal speed, tensor ``dt``): ``remat=True`` recomputes the
    same masks in the backward and gives the ``remat=False`` gradients, and
    both match the CPU's general band path."""
    _, tg, _, tb, phi, speed = _setup((24, 24, 32))
    grads = {}
    for label in ("remat", "plain", "general"):
        v = torch.from_numpy(phi).requires_grad_()
        s = torch.from_numpy(speed).requires_grad_()
        dt = torch.tensor(0.3 * tg.min_spacing, dtype=torch.float64, requires_grad=True)
        nb = TNB(v, tg, tb, nlayers=3, _normalized=True)
        terms = (T.CurvatureTerm(-0.01), T.NormalMotionTerm(T.MeshField(s, tg, tb,
                                                                         _normalized=True)))
        if label == "general":
            out, _ = T.rollout(T.RK3(), terms, nb, 0.0, dt, 2)
        else:
            out, _ = tloop._band_rollout(T.RK3(), terms, nb, 0.0, dt, 2,
                                         remat=label == "remat")
        grads[label] = torch.autograd.grad((out.values ** 2).sum(), (v, s, dt))
    for a, b, c in zip(grads["remat"], grads["plain"], grads["general"]):
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= 1e-12 * scale
        assert float((a - c).abs().max()) <= 1e-12 * scale


def test_band_step_stage_matches_its_plain_composite():
    """``band_step_stage`` under a gradient writes a copy of its target (the
    target is left as it was) equal to ``band_stage_refresh_plain``; without
    one it writes the target in place."""
    _, tg, _, tb, phi, speed = _setup((16, 16, 40))
    nb = TNB(torch.from_numpy(phi), tg, tb, nlayers=3, _normalized=True)
    term = T.NormalMotionTerm(T.MeshField(torch.from_numpy(speed), tg, tb, _normalized=True))
    stepper = TStepper((term,), nb, T.ForwardEuler(), tiles=(8, 8, 8))
    state = stepper.pack(nb)
    P, target = state.bufs
    terms = stepper.stage_terms(state, 0.0)
    args = (state.ids, state.band, state.flags, terms, (0.0, 1.0, 1e-3), None, tb,
            stepper.spacing, stepper.shape, stepper.tiles)
    before = target.clone()
    Pg = P.clone().requires_grad_()
    out = bd.band_step_stage(Pg, target, *args)
    assert out.grad_fn is not None and torch.equal(target, before)
    ref = bd.band_stage_refresh_plain(P, target, state.ids, state.band, terms, (0.0, 1.0, 1e-3),
                                      None, tb, stepper.spacing, stepper.shape, stepper.tiles)
    assert _err(out, ref) <= 1e-15
    inplace = bd.band_step_stage(P, target, *args)
    assert inplace is target and _err(target, ref) <= 1e-15
