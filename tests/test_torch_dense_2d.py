"""The dense 2D fused stepper on its native ``(n0+6, n1+6)`` layout, on the
CPU in float64 (the kernels' plain versions), against the JAX package at
small ragged sizes: ``integrate`` of configurations 2-4's terms (FE, RK2,
RK3) against JAX's 2D stepping, K2's 2D refresh against ``pad_ghost`` bit for
bit (and a model of its one-launch thread map), the 2D stage against the
``(1, n0, n1)`` embedding's, the 2D gradient against ``jax.grad``,
``update_func`` in 2D, and the CUDA refusal's label. All inputs come from
numpy seeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.core import bc as jbc
from lsm_tpu.models import shapes as jshapes
from lsm_tpu_torch.core import bc as tbc
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.ops import weno_v2 as tv2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


SHAPES = ((24, 40), (37, 64))


def _config(m, cfg, shape):
    """Configuration ``cfg`` (2 Zalesak, 3 vortex, 4 star) of
    ``models.benchmarks`` on a ``shape`` grid, for the package ``m``:
    ``(phi, terms)``; both packages' phi hold the JAX sample's values."""
    pkg, sh = (J, jshapes) if m is jnp else (T, tshapes)
    lo, hi = ((-1.0, -1.0), (1.0, 1.0)) if cfg == 4 else ((0.0, 0.0), (1.0, 1.0))
    fn, bc = {2: (jshapes.zalesak_disk(), "Periodic"),
              3: (jshapes.circle((0.5, 0.75), 0.15), "Extrapolation"),
              4: (jshapes.star(), "Extrapolation")}[cfg]
    vals = np.asarray(J.sample(fn, J.Grid(lo, hi, shape), dtype=jnp.float64).values)
    bc = pkg.Periodic() if bc == "Periodic" else pkg.Extrapolation(2)
    if cfg == 4:
        terms = (pkg.CurvatureTerm(-0.05), pkg.NormalMotionTerm(0.2))
    elif cfg == 2:
        terms = (pkg.AdvectionTerm(sh.rigid_rotation_velocity((0.5, 0.5), 2.0 * math.pi)),)
    else:
        terms = (pkg.AdvectionTerm(sh.vortex_velocity(period=4.0)),)
    grid = pkg.Grid(lo, hi, shape)
    values = jnp.asarray(vals) if m is jnp else torch.from_numpy(vals.copy())
    return pkg.MeshField(values, grid, bc), terms


INTEGRATORS = {"FE": "ForwardEuler", "RK2": "RK2", "RK3": "RK3"}


@pytest.mark.parametrize("integ", list(INTEGRATORS))
@pytest.mark.parametrize("cfg", [2, 3, 4])
def test_stepper_integrate_matches_jax(cfg, integ):
    """``integrate`` of configurations 2-4's terms on a ragged 2D grid
    through the port's fused stepper (its ``(n0+6, n1+6)`` buffers, the
    kernels' plain versions) against JAX's 2D stepping (its general path,
    as JAX's own 2D tests hold its fused path), three steps, f64."""
    shape = SHAPES[(cfg + len(integ)) % 2]
    jphi, jterms = _config(jnp, cfg, shape)
    tphi, tterms = _config(torch, cfg, shape)
    stepper = tfused.FusedStepper(tterms, tphi, getattr(T, INTEGRATORS[integ])())
    assert stepper.shape == shape and stepper.spacing == tuple(tphi.grid.spacing)
    assert tuple(stepper.pack(tphi.values).shape) == tuple(n + 6 for n in shape)
    jeq = J.LevelSetEquation(terms=jterms, ic=jphi, integrator=getattr(J, INTEGRATORS[integ])())
    teq = T.LevelSetEquation(terms=tterms, ic=tphi, integrator=getattr(T, INTEGRATORS[integ])())
    jeq.integrate(1.0, max_steps=3, fast="off")
    teq.integrate(1.0, max_steps=3)
    assert teq.last_fast_path == "fused" and teq.last_nsteps == 3
    assert abs(teq.t - jeq.t) <= 1e-14 * jeq.t
    want = np.asarray(jeq.state.values)
    np.testing.assert_allclose(_np(teq.state.values), want, rtol=0,
                               atol=1e-10 * max(np.abs(want).max(), 1.0))


def _bcs2():
    return {"periodic": lambda m: m.Periodic(), "symmetry": lambda m: m.Symmetry(),
            "extrap0": lambda m: m.Extrapolation(0), "extrap2": lambda m: m.Extrapolation(2),
            "mixed": lambda m: [(m.Symmetry(), m.Extrapolation(1)),
                                (m.Extrapolation(7), m.Symmetry())]}


def _ghost_of(bc, side, k, n, node, dt):
    """One ghost as K2's 2D kernel forms it (``csrc/refresh_ghosts.cu``
    ``ghost_of``): each product and sum rounded to ``dt`` on its own."""
    if isinstance(bc, tbc.Periodic):
        return node(n - 1 - k if side == 0 else k)
    if isinstance(bc, tbc.Symmetry):
        return node(k if side == 0 else n - 1 - k)
    w = tbc._lagrange_extrap_weights(3, bc.degree)[3 - k]
    m0, step = (0, 1) if side == 0 else (n - 1, -1)
    val = dt(0.0) + dt(w[0]) * node(m0)
    for j in range(1, bc.degree + 1):
        val = val + dt(w[j]) * node(m0 + j * step)
    return val


def _refresh_2d_model(vals, bcs):
    """A model of K2's one-launch 2D refresh, thread by thread: the axis-0
    ghosts of the interior columns, the axis-1 ghosts of every padded row,
    a corner's axis-0 values recomputed from the interior."""
    n0, n1 = vals.shape
    dt = vals.dtype.type
    P = np.full((n0 + 6, n1 + 6), np.nan, dtype=vals.dtype)
    P[3:3 + n0, 3:3 + n1] = vals

    def slot(g6, n):
        side, layer = divmod(g6, 3)
        return side, (3 - layer if side == 0 else layer + 1), (layer if side == 0 else 3 + n + layer)

    for t in range(6 * n1):
        b, g6 = t % n1, t // n1
        side, k, pos = slot(g6, n0)
        P[pos, 3 + b] = _ghost_of(bcs[0][side], side, k, n0, lambda m: vals[m, b], dt)
    for r in range(6 * (n0 + 6)):
        row, g6 = divmod(r, 6)
        side, k, pos = slot(g6, n1)
        if 3 <= row < 3 + n0:
            P[row, pos] = _ghost_of(bcs[1][side], side, k, n1, lambda m: vals[row - 3, m], dt)
        else:
            s0, k0, _ = slot(row if row < 3 else row - n0, n0)
            P[row, pos] = _ghost_of(bcs[1][side], side, k, n1, lambda m: _ghost_of(
                bcs[0][s0], s0, k0, n0, lambda i: vals[i, m], dt), dt)
    return P


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(_bcs2()))
def test_refresh_2d_equals_pad_ghost(case, dtype):
    """K2's 2D entry (its plain version on the CPU) rewrites every shell of
    a scribbled ``(n0+6, n1+6)`` buffer equal to ``pad_ghost`` of the
    interior bit for bit; the one-launch kernel's thread map (a model of
    ``refresh_2d_kernel``) gives the same bits; JAX's ``pad_ghost`` agrees
    (copies bit for bit, Lagrange sums to round-off)."""
    make = _bcs2()[case]
    shape = SHAPES[1]
    tb = tbc.normalize_bcs(make(T), 2)
    rng = np.random.default_rng(3 + len(case))
    vals = rng.standard_normal(shape)
    tv = torch.from_numpy(vals).to(dtype)
    P = tv2.pack_padded(tv, tb)
    inner = torch.zeros_like(P, dtype=torch.bool)
    tv2.unpack_padded(inner, shape).fill_(True)
    P[~inner] = torch.from_numpy(rng.standard_normal(int((~inner).sum()))).to(dtype)
    assert tv2.refresh_ghosts_fast(P, tb, shape) is P
    want = tbc.pad_ghost(tv, tb, 3)
    assert torch.equal(P, want)
    model = _refresh_2d_model(_np(tv), tb)
    assert np.array_equal(model, _np(want))
    jwant = np.asarray(jbc.pad_ghost(jnp.asarray(_np(tv)), jbc.normalize_bcs(make(J), 2), 3))
    if case in ("periodic", "symmetry", "extrap0"):
        np.testing.assert_array_equal(_np(P), jwant)
    else:
        tol = (1e-5 if dtype == torch.float32 else 1e-13) * np.abs(jwant).max()
        np.testing.assert_allclose(_np(P), jwant, rtol=0, atol=tol)


def _stage_cases(tphi, rng):
    """Term lists of the 2D stepper: the configurations' and a few more
    (streamed velocity and speed, both eikonal signs, a program speed)."""
    shape = tuple(tphi.shape)
    vel = T.MeshField(torch.from_numpy(0.5 * rng.standard_normal((2, *shape))), tphi.grid)
    speed = T.MeshField(torch.from_numpy(0.1 + 0.05 * rng.standard_normal(shape)), tphi.grid)
    return {
        "rotation": (T.AdvectionTerm(tshapes.rigid_rotation_velocity((0.5, 0.5), 1.0)),),
        "vortex": (T.AdvectionTerm(tshapes.vortex_velocity(period=4.0)),),
        "stream": (T.AdvectionTerm(vel),),
        "star": (T.CurvatureTerm(-0.05), T.NormalMotionTerm(0.2)),
        "kinds": (T.CurvatureTerm(-0.05), T.NormalMotionTerm(speed), T.AdvectionTerm(vel)),
        "eikonal": (T.EikonalReinitializationTerm(),
                    T.EikonalReinitializationTerm.from_initial(tphi)),
        "program speed": (T.NormalMotionTerm(lambda xs, t: 0.1 + 0.2 * xs[0] * xs[1] + t),),
    }


@pytest.mark.parametrize("aux", [False, True], ids=["noaux", "aux"])
def test_stage_equals_embedding_stage(aux):
    """The 2D stage on the native layout (the stepper's 2D term list: two
    streamed velocity components, the embedding's programs) equals the
    ``(1, n0, n1)`` embedding's plain stage on the same interior to
    round-off, for every term list of :func:`_stage_cases`; each list's
    route on the card is a 2D entry (the march or one thread per node), and
    no streamed velocity gains a zero component."""
    grid = T.Grid((0.0, -0.5), (1.0, 0.9), SHAPES[0])
    rng = np.random.default_rng(21)
    tphi = T.MeshField(torch.from_numpy(0.3 * rng.standard_normal(grid.shape)), grid,
                       [(T.Symmetry(), T.Extrapolation(1)), T.Periodic()])
    routes = {}
    for name, terms in _stage_cases(tphi, rng).items():
        st = tfused.FusedStepper(terms, tphi, T.RK3())
        routes[name] = st.stage_route
        assert all(len(a) == (2 if s.kind == "advection" else 1)
                   for s, a in st.entries if s.coef_kind == "stream")
        P = st.pack(tphi.values)
        A = st.pack(torch.from_numpy(rng.standard_normal(grid.shape))) if aux else None
        coeffs = (0.75, 0.25, 2.5e-3) if aux else (0.0, 1.0, 1e-2)
        got = tv2.unpack_padded(tv2.fused_stage(P, st.stage_terms(0.3), coeffs, A, st.spacing,
                                                st.shape, tv2.Where(st.lo, None, 0.3)), st.shape)
        shape3, bcs3, spacing3, lo3 = tfused.embed_2d(tphi)
        terms3 = tfused.term_entries(terms, tphi)
        P3 = tv2.pack_padded(tphi.values[None], bcs3)
        A3 = None if A is None else tv2.pack_padded(tv2.unpack_padded(A, st.shape)[None], bcs3)
        xs3 = tv2.node_coords(shape3, spacing3, lo3, torch.float64)
        terms3 = tv2.resolve_terms(terms3, xs3, 0.3, shape3, torch.float64, "cpu")
        want = tv2.unpack_padded(tv2.stage_plain(P3, terms3, coeffs, A3, spacing3, shape3,
                                                 tv2.Where(lo3, None, 0.3)), shape3)[0]
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= 1e-13 * scale, name
    assert routes == {"rotation": "K1'' 2D march", "vortex": "K1'' 2D per node",
                      "stream": "K1 2D march", "star": "K1' 2D per node",
                      "kinds": "K1' 2D per node", "eikonal": "K1' 2D per node",
                      "program speed": "K1' 2D per node"}


def test_stage_takes_two_velocity_tensors():
    """The 2D stage takes the two velocity components as tensors (one
    streamed advection term) and refuses three."""
    shape = (20, 24)
    rng = np.random.default_rng(4)
    bcs = tbc.normalize_bcs(tbc.Periodic(), 2)
    P = tv2.pack_padded(torch.from_numpy(rng.standard_normal(shape)), bcs)
    u = tuple(torch.from_numpy(rng.standard_normal(shape)) for _ in range(2))
    sp = (0.1, 0.2)
    got = tv2.fused_stage(P, u, (0.0, 1.0, 1e-2), None, sp, shape)
    spec = ((tv2.TermSpec("advection", "stream", None, 2), u),)
    want = tv2.stage_plain(P, spec, (0.0, 1.0, 1e-2), None, sp, shape)
    assert torch.equal(tv2.unpack_padded(got, shape), tv2.unpack_padded(want, shape))
    with pytest.raises(ValueError, match="needs 2 components"):
        tv2.fused_stage(P, (*u, u[0]), (0.0, 1.0, 1e-2), None, sp, shape)
    assert tv2.stage_route(tv2.as_terms(u), shape) == "K1 2D march"


def test_gradient_of_kinds_matches_jax():
    """A 2D rollout of a term list (curvature + normal motion at a streamed
    speed) differentiates through the stepper on the CPU (autograd of the
    plain 2D stage and refresh) as ``jax.grad`` of JAX's general path, with
    respect to phi and the speed."""
    shape = (20, 26)
    args = ((-1.0, -1.0), (1.0, 1.0), shape)
    rng = np.random.default_rng(8)
    jphi = J.sample(jshapes.star(), J.Grid(*args), J.Extrapolation(2), dtype=jnp.float64)
    vals = np.array(jphi.values) + 1e-3 * rng.standard_normal(shape)
    speed = 0.2 + 0.05 * rng.standard_normal(shape)
    tphi = T.MeshField(torch.from_numpy(vals), T.Grid(*args), T.Extrapolation(2))
    dt = 0.2 * jphi.grid.min_spacing ** 2 / 0.05 / 4

    def jloss(v, s):
        terms = (J.CurvatureTerm(-0.05), J.NormalMotionTerm(J.MeshField(s, jphi.grid)))
        out, _ = J.rollout(J.RK2(), terms, jphi.with_values(v), 0.0, dt, 2, fast="off")
        return jnp.sum(out.values ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(speed))
    v = torch.from_numpy(vals).requires_grad_()
    s = torch.from_numpy(speed).requires_grad_()
    terms = (T.CurvatureTerm(-0.05), T.NormalMotionTerm(T.MeshField(s, tphi.grid)))
    assert tfused.unsupported_reason(terms, tphi, T.RK2()) is None
    out, _ = T.rollout(T.RK2(), terms, tphi.with_values(v), 0.0, dt, 2)
    got = torch.autograd.grad((out.values ** 2).sum(), (v, s))
    for g, w in zip(got, jg):
        w = np.asarray(w)
        assert float(np.abs(_np(g) - w).max()) <= 1e-9 * float(np.abs(w).max())


def test_update_func_matches_jax():
    """An ``update_func`` normal speed on a 2D field: the port's fused
    stepper (``step_with_terms`` on the 2D layout) against JAX's 2D
    stepping, three RK3 steps, the state and the refreshed speed."""
    shape = SHAPES[0]

    def term(m, phi):
        pkg = J if m is jnp else T

        def speed(s, phi, t):
            return pkg.MeshField(0.05 + 0.02 * m.tanh(phi.values) + 0.1 * t, phi.grid)

        return pkg.NormalMotionTerm(pkg.MeshField(0.05 + 0.0 * phi.values, phi.grid),
                                    update_func=speed)

    jphi, _ = _config(jnp, 4, shape)
    tphi, _ = _config(torch, 4, shape)
    jeq = J.LevelSetEquation(terms=(term(jnp, jphi),), ic=jphi, integrator=J.RK3())
    teq = T.LevelSetEquation(terms=(term(torch, tphi),), ic=tphi, integrator=T.RK3())
    jeq.integrate(1.0, max_steps=3, fast="off")
    teq.integrate(1.0, max_steps=3)
    assert teq.last_fast_path == "fused" and teq.last_nsteps == 3
    assert abs(teq.t - jeq.t) <= 1e-14 * jeq.t
    want = np.asarray(jeq.state.values)
    np.testing.assert_allclose(_np(teq.state.values), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(_np(teq.terms[0].speed.values),
                               np.asarray(jeq.terms[0].speed.values), rtol=0, atol=1e-12)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: drives the CUDA route without
    a card (its checks and its routing; the wrappers then run their plain
    versions, the data lying on the CPU). The other port tests import it."""

    @property
    def is_cuda(self):
        return True


def test_cuda_gradient_refusal_names_its_label():
    """A gradient through the dense 2D stepper is no longer refused on CUDA:
    ``gradient_reason`` is ``None`` for a 2D field (a term list too), the
    CUDA route's rollout (a tensor that reports ``is_cuda``) runs every stage
    through ``_FusedStepStage`` and gives the CPU's gradient, and the
    differentiable 2D stage still refuses a tensor off the CPU and the card."""
    grid = T.Grid((-1.0, -1.0), (1.0, 1.0), (12, 16))
    phi = T.sample(tshapes.star(), grid, T.Extrapolation(2), dtype=torch.float64, device="cpu")
    terms = (T.CurvatureTerm(-0.05), T.NormalMotionTerm(0.2))
    assert tfused.gradient_reason(terms, phi) is None
    assert tfused.gradient_reason((T.AdvectionTerm(lambda xs, t: (-xs[1], xs[0])),), phi) is None
    grads = []
    for vals in (phi.values.clone(), phi.values.clone().as_subclass(_CudaTyped)):
        v = vals.requires_grad_()
        out, _ = T.rollout(T.RK3(), terms, phi.with_values(v), 0.0, 1e-4, 2)
        assert out.values.grad_fn is not None
        grads.append(torch.autograd.grad((out.values ** 2).sum(), v)[0])
    assert torch.equal(grads[1].as_subclass(torch.Tensor), grads[0])
    st = tfused.FusedStepper(terms, phi, T.RK3())
    P = st.pack(phi.values).requires_grad_()
    out = tv2.fused_step_stage(P, st.stage_terms(0.0), (0.0, 1.0, 1e-4), None, st.bcs,
                               st.spacing, st.shape)
    assert "_FusedStepStage" in type(out.grad_fn).__name__
    with pytest.raises(ValueError, match="only cpu and cuda"):
        tv2.fused_step_stage(P.detach().to("meta").requires_grad_(), st.stage_terms(0.0),
                             (0.0, 1.0, 1e-4), None, st.bcs, st.spacing, st.shape)
