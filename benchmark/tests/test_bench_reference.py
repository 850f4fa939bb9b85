"""The benchmark's frozen reference against the port's CPU path at 32^3, in
float64, where the two differ by rounding alone: the forward states of
``integrate`` and the gradients of a rollout."""

import copy
import json

import pytest
import torch

import lsm_tpu_torch as lsm
from benchmark import drivers, inputs
from benchmark import reference as ref
from benchmark.tests.conftest import ROOT

N = 32


def cfg(name):
    c = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    c["dtype"] = "float64"
    return c


def program_objects(c, group):
    shape = inputs.grid_shape(c, N)
    terms_cfg = inputs.terms_of(c, group)
    coefs = [inputs.coefficient(t, c, shape, "cpu") for t in terms_cfg]
    grid, bc = drivers._program_grid(lsm, c, shape)
    return terms_cfg, coefs, grid, bc


@pytest.mark.parametrize("name", ["zalesak_sphere_512", "torus_mcf_512"])
def test_integrate_matches_the_port(name):
    c = cfg(name)
    terms_cfg, coefs, grid, bc = program_objects(c, "forward")
    phi0 = inputs.initial_field(c, {"center_jitter_cells": 1.0}, 20261019, "cpu", N)
    eq = lsm.LevelSetEquation(terms=drivers._program_terms(lsm, terms_cfg, coefs, grid, bc),
                              ic=lsm.MeshField(phi0, grid, bc), integrator=lsm.RK3())
    eq.integrate(1e6, max_steps=4)
    assert eq.last_fast_path == "fused"
    prob = inputs.problem(c, terms_cfg, coefs, "cpu", N)
    want, t, steps = ref.integrate(phi0, 0.0, 1e6, 4, prob)
    assert steps == eq.last_nsteps == 4
    assert t == pytest.approx(eq.t, rel=1e-14)
    assert drivers.rel_max_gap(eq.state.values, want) < 1e-12


@pytest.mark.parametrize("name,nsteps", [("zalesak_sphere_512", 3), ("torus_mcf_512", 2)])
def test_rollout_gradient_matches_the_port(name, nsteps):
    c = cfg(name)
    terms_cfg, coefs, grid, bc = program_objects(c, "gradient")
    phi0 = inputs.initial_field(c, {"center_jitter_cells": 1.0}, 7, "cpu", N)
    streams = [x if inputs.is_streamed(x) else None for x in coefs]
    prob = inputs.problem(c, terms_cfg, coefs, "cpu", N)
    dt = inputs.gradient_dt(c, prob, streams)
    v = phi0.detach().requires_grad_()
    leaves = [x.detach().requires_grad_() if inputs.is_streamed(x) else x for x in coefs]
    wrt = [v] + [x for x in leaves if inputs.is_streamed(x)]
    out, _ = lsm.rollout(lsm.RK3(), drivers._program_terms(lsm, terms_cfg, leaves, grid, bc),
                         lsm.MeshField(v, grid, bc), 0.0, dt, nsteps, remat=True)
    loss = (out.values ** 2).sum()
    got = torch.autograd.grad(loss, wrt)
    loss_ref, g_ref, gs_ref = ref.rollout_grad(phi0, dt, nsteps, prob, streams)
    assert float(loss.detach()) == pytest.approx(loss_ref, rel=1e-13)
    assert drivers.rel_max_gap(got[0], g_ref) < 1e-11
    for mine, want in zip(got[1:], [g for g in gs_ref if g is not None]):
        assert drivers.rel_max_gap(mine, want) < 1e-11


def test_slabs_do_not_change_the_answer():
    c = cfg("torus_mcf_512")
    terms_cfg, coefs, _, _ = program_objects(c, "gradient")
    phi0 = inputs.initial_field(c, {"center_jitter_cells": 1.0}, 3, "cpu", N)
    streams = [x if inputs.is_streamed(x) else None for x in coefs]
    whole = inputs.problem(c, terms_cfg, coefs, "cpu", N)
    sliced = copy.copy(whole)
    sliced.slab_elems = 3 * (N + 6) ** 2
    a = ref.rollout_grad(phi0, 1e-4, 1, whole, streams)
    b = ref.rollout_grad(phi0, 1e-4, 1, sliced, streams)
    assert a[0] == pytest.approx(b[0], rel=1e-14)
    assert drivers.rel_max_gap(b[1], a[1]) < 1e-13
