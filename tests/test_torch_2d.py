"""2D fields in the port against the JAX package, on the CPU in float64: the
canonical configurations 1 to 4 (``models.benchmarks``; 2 to 4 through the
fused stepper on its ``(n0+6, n1+6)`` layout, which computes the function of
JAX's ``(1, n0, n1)`` embedding, 1 through the general path), the ghost
refresh (K2's plain version) on a 3D field's length-1 axis, the 2D shapes
and velocities, the CFL bound, and gradients through the 2D stepper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.core import bc as jbc
from lsm_tpu.models import benchmarks as jbench
from lsm_tpu.models import shapes as jshapes
from lsm_tpu.ops import weno_v2 as jv2
from lsm_tpu_torch.core import bc as tbc
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.models import benchmarks as tbench
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.ops import weno_v2 as tv2
from test_torch_dense_2d import _CudaTyped


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _build(cfg, n):
    """Configuration ``cfg`` at ``n^2`` from both packages (f64, CPU)."""
    name = {1: "config1_circle_advection", 2: "config2_zalesak", 3: "config3_vortex_spiral",
            4: "config4_curvature_normal"}[cfg]
    jeq = getattr(jbench, name)(n, dtype=jnp.float64)
    teq = getattr(tbench, name)(n, dtype=torch.float64, device="cpu")
    if cfg == 1:
        (jeq, jexact), (teq, texact) = jeq, teq
        np.testing.assert_allclose(_np(texact(0.3).values), np.asarray(jexact(0.3).values),
                                   rtol=0, atol=1e-14)
    return jeq, teq


# a few adaptive steps each, the last one cut to land on tf
TF = {1: 0.2, 2: 0.01, 3: 0.02, 4: 0.06}


@pytest.mark.parametrize("cfg", [1, 2, 3, 4])
def test_config_matches_jax_general_path(cfg):
    """The port (configs 2-4 through the 2D fused stepper on the kernels'
    plain versions, config 1 through the general path) against JAX's
    general path, equal step counts, float64."""
    jeq, teq = _build(cfg, 32)
    jsteps = []
    jeq.integrate(TF[cfg], fast="off", posthook=lambda e: jsteps.append(e.t))
    teq.integrate(TF[cfg])
    assert teq.last_fast_path == (None if cfg == 1 else "fused")
    assert teq.last_nsteps == len(jsteps) >= 2 and teq.t == jeq.t == TF[cfg]
    np.testing.assert_allclose(_np(teq.state.values), np.asarray(jeq.state.values), rtol=0,
                               atol=1e-10)


def test_config2_matches_jax_embedded_pallas_interpret():
    """Configuration 2 against JAX's own embedded fused path (K1/K2 in
    interpret mode; JAX's layout needs the last axis a multiple of 128)."""
    jeq, teq = _build(2, 128)
    tf = 2 * 0.5 * jeq.grid.min_spacing / (2.0 * np.pi)  # two steps
    jeq.integrate(tf, fast="interpret")
    teq.integrate(tf)
    assert jeq.last_fast_path == teq.last_fast_path == "fused" and teq.last_nsteps == 2
    np.testing.assert_allclose(_np(teq.state.values), np.asarray(jeq.state.values), rtol=0,
                               atol=1e-10)


def test_config4_cfl_is_the_2d_bound():
    """The 2D stepper's CFL bound is taken on the 2D field and terms; the
    stepper keeps the field's own shape, spacing and boundary conditions
    (no embedding's dummy axis)."""
    jeq, teq = _build(4, 40)
    stepper = tfused.FusedStepper(teq.terms, teq.state, teq.integrator)
    got = float(stepper.cfl(stepper.pack(teq.state.values), 0.0))
    want = float(J.compute_cfl(jeq.terms, jeq.state, 0.0))
    assert got == pytest.approx(want, rel=1e-15)
    assert stepper.spacing == tuple(teq.grid.spacing) and stepper.shape == (40, 40)
    assert stepper.bcs == teq.state.bcs


def _bcs2():
    return {"periodic": lambda m: m.Periodic(), "symmetry": lambda m: m.Symmetry(),
            "extrap0": lambda m: m.Extrapolation(0), "extrap2": lambda m: m.Extrapolation(2),
            "mixed": lambda m: [(m.Symmetry(), m.Extrapolation(1)),
                                (m.Extrapolation(3), m.Symmetry())]}


@pytest.mark.parametrize("case", list(_bcs2()))
def test_refresh_length_one_axis_matches_jax(case):
    """K2's plain version on ``(1, n0, n1)`` with the dummy axis's
    Extrapolation(0): exactly JAX's ``pad_ghost`` of the embedded field, and
    JAX's ``refresh_ghosts`` on the shells both layouts hold."""
    make = _bcs2()[case]
    shape = (1, 12, 128)
    tb = ((tbc.Extrapolation(0), tbc.Extrapolation(0)), *tbc.normalize_bcs(make(T), 2))
    jb = ((jbc.Extrapolation(0), jbc.Extrapolation(0)), *jbc.normalize_bcs(make(J), 2))
    rng = np.random.default_rng(len(case))
    vals = rng.standard_normal(shape)
    P = tv2.pack_padded(torch.from_numpy(vals), tb)
    inner = torch.zeros_like(P, dtype=torch.bool)
    tv2.unpack_padded(inner, shape).fill_(True)
    P[~inner] = torch.from_numpy(rng.standard_normal(int((~inner).sum())))  # scribble
    tv2.refresh_ghosts_fast(P, tb, shape)
    # the dummy axis's ghosts are copies of its node, every plane alike
    assert bool((P[:3] == P[3]).all()) and bool((P[4:] == P[3]).all())
    n1 = shape[1]
    JP = jv2.pack_padded(jnp.asarray(vals), jb)
    JP = JP.at[0:3].add(7.0).at[-3:].add(-3.0).at[:, 5:8].add(2.0).at[:, -8:-5].add(1.0)
    refs = ((_np(P), np.asarray(jbc.pad_ghost(jnp.asarray(vals), jb, 3))),
            (_np(P[:, :, 3:3 + shape[2]]), np.asarray(jv2.refresh_ghosts(JP, jb, shape))[
                :, 5:11 + n1, :]))
    for got, want in refs:
        if case in ("periodic", "symmetry", "extrap0"):  # copies only: bit for bit
            np.testing.assert_array_equal(got, want)
        else:  # Lagrange sums of the real axes, which XLA may contract: to round-off
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-14 * np.abs(want).max())
    kinds, degrees, _ = tv2._ghost_args(tb, shape)
    assert list(kinds)[:2] == [2, 2] and list(degrees)[:2] == [0, 0]


def test_refresh_refuses_short_periodic_and_symmetry_axes():
    """Periodic and Symmetry ghosts still need 4 nodes; Extrapolation(d)
    needs d + 1."""
    for b, n in ((tbc.Periodic(), 3), (tbc.Symmetry(), 1), (tbc.Extrapolation(2), 2)):
        bcs = ((b, b), *tbc.normalize_bcs(tbc.Periodic(), 2))
        with pytest.raises(ValueError, match="needs >= 4|degree \\+ 1"):
            tv2._ghost_args(bcs, (n, 8, 8))
    tv2._ghost_args(((tbc.Extrapolation(1),) * 2, *tbc.normalize_bcs(tbc.Periodic(), 2)),
                    (2, 8, 8))


def test_shapes_match_jax():
    xs = np.linspace(-1.0, 1.0, 17)
    ys = np.linspace(-0.5, 1.5, 19)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    jX, jY, tX, tY = jnp.asarray(X), jnp.asarray(Y), torch.from_numpy(X), torch.from_numpy(Y)
    for name, args in (("star", ()), ("star", ((0.1, -0.2), 0.4, 0.15, 3, 0.3)),
                       ("zalesak_disk", ()), ("dumbbell", ()), ("plane", ((1.0, 2.0), 0.3)),
                       ("circle", ((0.2, 0.1), 0.6))):
        want = np.asarray(getattr(jshapes, name)(*args)(jX, jY))
        got = _np(getattr(tshapes, name)(*args)(tX, tY))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14, err_msg=name)
    for period in (None, 2.0):
        for t in (0.0, 0.7):
            want = jshapes.vortex_velocity(period)((jX, jY), t)
            got = tshapes.vortex_velocity(period)((tX, tY), t)
            for a, b in zip(got, want):
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-14)
    got = tshapes.vortex_velocity(2.0)((tX, tY), torch.tensor(0.7, dtype=torch.float64))
    want = jshapes.vortex_velocity(2.0)((jX, jY), 0.7)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=0, atol=1e-14)


def test_embedding_keeps_the_eikonal_smoothing_spacing():
    """The recomputed eikonal sign smooths with ``min(spacing)``: on a grid
    whose spacing exceeds 1 the 2D stepper (the embedding's function, its
    dummy axis at the field's smallest spacing) still matches the 2D general
    path (a dummy spacing of 1 would not)."""
    grid = T.Grid((0.0, 0.0), (40.0, 40.0), (21, 21))
    phi = T.sample(lambda x, y: 0.3 * ((x - 20.0) ** 2 + (y - 18.0) ** 2 - 100.0) / 10.0,
                   grid, T.Extrapolation(1), dtype=torch.float64, device="cpu")
    term = (T.EikonalReinitializationTerm(),)
    fused = T.LevelSetEquation(terms=term, ic=phi, integrator=T.RK2())
    fused.integrate(3.0)
    general = T.LevelSetEquation(terms=term, ic=phi, integrator=T.RK2())
    general.integrate(3.0, fast="off")
    assert fused.last_fast_path == "fused" and general.last_fast_path is None
    assert fused.last_nsteps == general.last_nsteps >= 2
    np.testing.assert_allclose(_np(fused.state.values), _np(general.state.values), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("velocity", ["stream", "callable"])
def test_rollout_gradient_through_the_embedding_matches_jax(velocity):
    """On the CPU autograd runs through the 2D stepper (each stage a
    ``_FusedStepStage``, whose backward is the plain versions of the 2D K4,
    K3 and K5); against ``jax.grad`` of JAX's general path, also on the CUDA
    route (a tensor that reports ``is_cuda``)."""
    shape = (20, 24)
    args = ((0.0, 0.0), (1.0, 1.0), shape)
    rng = np.random.default_rng(9)
    jphi = J.sample(jshapes.zalesak_disk(), J.Grid(*args), J.Periodic(), dtype=jnp.float64)
    vals = np.array(jphi.values) + 1e-3 * rng.standard_normal(shape)
    tphi = T.MeshField(torch.from_numpy(vals), T.Grid(*args), T.Periodic())
    velf = lambda xs, t: (0.5 - xs[1] + 0.0 * xs[0], xs[0] - 0.5 + 0.3 * t + 0.0 * xs[1])
    vel = 0.5 * rng.standard_normal((2, *shape))
    dt = 0.25 * jphi.grid.min_spacing
    jterm = (J.AdvectionTerm(velf) if velocity == "callable"
             else J.AdvectionTerm(J.MeshField(jnp.asarray(vel), jphi.grid)))
    tterm = (T.AdvectionTerm(velf) if velocity == "callable"
             else T.AdvectionTerm(T.MeshField(torch.from_numpy(vel), tphi.grid)))

    def jloss(v):
        out, _ = J.rollout(J.RK3(), (jterm,), jphi.with_values(v), 0.0, dt, 3, fast="off")
        return jnp.sum(out.values ** 2)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(vals)))
    v = torch.from_numpy(vals).requires_grad_()
    assert tfused.unsupported_reason((tterm,), tphi, T.RK3()) is None
    out, _ = T.rollout(T.RK3(), (tterm,), tphi.with_values(v), 0.0, dt, 3)
    (g,) = torch.autograd.grad((out.values ** 2).sum(), v)
    assert float(np.abs(_np(g) - jg).max()) <= 1e-9 * float(np.abs(jg).max())
    # the CUDA route takes this gradient too: the 2D entries of K4, K3 and K5
    assert tfused.gradient_reason((tterm,), tphi) is None
    cv = torch.from_numpy(vals).as_subclass(_CudaTyped).requires_grad_()
    out, _ = T.rollout(T.RK3(), (tterm,), tphi.with_values(cv), 0.0, dt, 3)
    (gc,) = torch.autograd.grad((out.values ** 2).sum(), cv)
    assert cv.is_cuda and float(np.abs(_np(gc) - jg).max()) <= 1e-9 * float(np.abs(jg).max())
