"""The normal-motion, curvature and eikonal kinds of the fused stage (K1) and
the band stage (K6), and sums of terms, against the JAX package on the CPU
in float64 (the wrappers run their plain versions on CPU tensors):

- the stage per kind and coefficient kind, and a 3-term sum with ``aux``,
  against ``lsm_tpu.ops.weno_v2.stage_reference`` (``1e-12 * max(|ref|, 1)``);
- ``LevelSetEquation.integrate`` through the fused stepper against JAX's
  general path (``1e-10``, the same steps and ``dt``);
- the band stepper against JAX's dense band path (``1e-11``, equal masks);
- a rollout gradient through a streamed speed against ``jax.grad``;
- what CUDA refuses, through the reason functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.integrators.loop import step as jstep
from lsm_tpu.models import shapes as jshapes
from lsm_tpu.ops import weno_v2 as jv2
from lsm_tpu_torch.integrators import band_fused as tband
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import weno_v2 as tv2
from lsm_tpu_torch.utils.checkpoint import field_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


def _speed(xs, t):
    """A speed that changes sign across the domain (both Godunov branches)."""
    return 0.3 * xs[0] - 0.1 * (xs[1] + xs[2]) + 0.05 + 0.2 * t


def _velf(xs, t):
    # rigid rotation about the z axis plus a drift along z; jnp and torch alike
    return (0.5 - xs[1] + 0.0 * (xs[0] + xs[2]), xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
            0.1 + 0.0 * (xs[0] + xs[1] + xs[2]))


def _field(shape, fn, bcs, lo=(-1.0, -1.0, -1.0), hi=(1.0, 1.0, 1.0)):
    """The same field in both packages (float64, CPU); ``bcs`` maps a package
    to its boundary conditions."""
    jphi = J.sample(fn(jshapes), J.Grid(lo, hi, shape), bcs(J), dtype=jnp.float64)
    tphi = field_from_numpy(np.array(jphi.values), T.Grid(lo, hi, shape), bcs(T), device="cpu")
    return jphi, tphi


def _wavy(pkg):
    """The torus times (0.5 + |x|^2): its zero set is the torus, |grad| != 1."""
    tor = pkg.torus((0.0, 0.0, 0.0), 0.5, 0.2)
    return lambda x, y, z: tor(x, y, z) * (0.5 + x * x + y * y + z * z)


# -- the stage per kind -------------------------------------------------------------------

SHAPE = (16, 16, 128)
STAGE_CASES = ["normal_const", "normal_stream", "normal_callable", "curvature_const",
               "curvature_stream", "eikonal_none", "eikonal_stream", "sum3_aux"]


def _mixed_bcs(pkg):
    return [(pkg.Symmetry(), pkg.Extrapolation(1)), pkg.Periodic(),
            (pkg.Extrapolation(2), pkg.Symmetry())]


#: the march's edge shapes beside SHAPE: the 2D embedding (axis 0 compiled
#: out on the card), axis 0 past one chunk of 64 planes, columns that tile
#: neither axis 1 (16) nor axis 2 (32)
STAGE_SHAPES = {"16x16x128": SHAPE, "embedding": (1, 37, 75), "past_chunk": (67, 20, 33),
                "ragged": (9, 37, 40)}


def _stage_field(shape):
    """``(JAX values, port values, JAX bcs, port bcs, spacing, lo)`` of the
    wavy torus at ``shape`` under :func:`_mixed_bcs`; the embedding (n0 = 1)
    takes the first plane of a 2-plane grid, with ``Extrapolation(0)``
    ghosts (copies of the plane) along axis 0."""
    if shape[0] == 1:
        jphi, tphi = _field((2, *shape[1:]), _wavy, _mixed_bcs)
        embed = lambda pkg, bcs: ((pkg.Extrapolation(0), pkg.Extrapolation(0)), *bcs[1:])
        return (jphi.values[:1], tphi.values[:1].contiguous(), embed(J, jphi.bcs),
                embed(T, tphi.bcs), tphi.grid.spacing, tphi.grid.lo)
    jphi, tphi = _field(shape, _wavy, _mixed_bcs)
    return jphi.values, tphi.values, jphi.bcs, tphi.bcs, tphi.grid.spacing, tphi.grid.lo


@pytest.mark.parametrize("where", list(STAGE_SHAPES))
@pytest.mark.parametrize("case", STAGE_CASES)
def test_stage_kinds_match_jax_reference(case, where):
    """The plain K1 (``fused_stage`` on CPU tensors) and the port's oracle
    against JAX's ``stage_reference``, each on its own padded layout, at
    SHAPE and at the march's edge shapes; where JAX's Pallas stage takes
    the shape (its lane tile, 128, divides n2), against it in interpret mode
    too."""
    shape = STAGE_SHAPES[where]
    jvals, tvals, jbcs, tbcs, spacing, lo = _stage_field(shape)
    rng = np.random.default_rng(11)
    a = rng.standard_normal(shape)
    a[:, ::4] = 0.0  # ties: zero speed, zero weight, zero sign
    s0 = np.array(jvals) / np.sqrt(np.array(jvals) ** 2 + 1e-4)
    kind, coef = case.split("_")[0], case.split("_")[1]
    streams = {"normal": a, "curvature": -np.abs(a), "eikonal": s0}
    t, coeffs, aux = 0.3, (0.0, 1.0, 0.5), None
    if case == "sum3_aux":
        vel = 0.5 * rng.standard_normal((3, *shape))
        specs = [("advection", "stream", None, list(vel)), ("curvature", "const", -0.01, []),
                 ("normal", "stream", None, [a])]
        coeffs, aux = (0.4, 0.6, 5e-2), np.array(jvals) * 1.1 + 0.05
    elif coef == "const":
        specs = [(kind, "const", 0.2 if kind == "normal" else -0.05, [])]
    elif coef == "callable":
        specs = [(kind, "analytic", _speed, [])]
    elif coef == "none":
        specs = [(kind, "none", None, [])]
    else:
        specs = [(kind, "stream", None, [streams[kind]])]
    jspec = tuple((jv2.TermSpec(k, c, v, len(s)), tuple(jnp.asarray(x) for x in s))
                  for k, c, v, s in specs)
    tspec = tuple((tv2.TermSpec(k, c, v, len(s)), tuple(torch.from_numpy(np.ascontiguousarray(x))
                                                         for x in s)) for k, c, v, s in specs)
    JP, TP = jv2.pack_padded(jvals, jbcs), tv2.pack_padded(tvals, tbcs)
    JA = None if aux is None else jv2.pack_padded(jnp.asarray(aux), jbcs)
    TA = None if aux is None else tv2.pack_padded(torch.from_numpy(aux), tbcs)
    ref = jv2.stage_reference(JP, jspec, coeffs, t, JA, jbcs, spacing, shape, lo)
    oracle = tv2.stage_reference(TP, tspec, coeffs, t, TA, tbcs, spacing, shape, lo)
    _close(_np(oracle), ref, 1e-12)
    xs = tv2.node_coords(shape, spacing, lo, torch.float64)
    resolved = tv2.resolve_terms(tspec, xs, t, shape, torch.float64, "cpu")
    assert all(spec.coef_kind != "analytic" for spec, _ in resolved)
    out = tv2.fused_stage(TP, resolved, coeffs, TA, spacing, shape)
    assert tv2.fused_stage.launches == 0
    _close(_np(tv2.unpack_padded(out, shape)), ref, 1e-12)
    if shape[2] % 128 == 0:  # JAX's Pallas stage takes the shape: interpret mode
        pallas = jv2.fused_stage(JP, jspec, coeffs, t, JA, jbcs, spacing, shape, lo,
                                 interpret=True)
        _close(_np(tv2.unpack_padded(out, shape)), jv2.unpack_padded(pallas, shape), 1e-12)


def test_stage_term_table_limits():
    shape = (6, 6, 6)
    P = torch.zeros(tv2.padded_shape(shape), dtype=torch.float64)
    sp = (0.1, 0.1, 0.1)
    normal = (tv2.TermSpec("normal", "const", 0.2, 0), ())
    out = tv2.fused_stage(P, (normal,) * tv2.MAX_TERMS, (0, 1, 1), None, sp, shape)
    assert bool(torch.isfinite(out[3:-3, 3:-3, 3:-3]).all())
    with pytest.raises(ValueError, match="1 to 16 terms"):
        tv2.fused_stage(P, (normal,) * (tv2.MAX_TERMS + 1), (0, 1, 1), None, sp, shape)
    with pytest.raises(ValueError, match="analytic"):
        tv2.fused_stage(P, ((tv2.TermSpec("normal", "analytic", _speed, 0), ()),), (0, 1, 1),
                        None, sp, shape)
    with pytest.raises(ValueError, match="needs 1 streams"):
        tv2.fused_stage(P, ((tv2.TermSpec("curvature", "stream", None, 1), ()),), (0, 1, 1),
                        None, sp, shape)
    with pytest.raises(ValueError, match="not a kernel input"):
        tv2.fused_stage(P, ((tv2.TermSpec("eikonal", "const", 1.0, 0), ()),), (0, 1, 1),
                        None, sp, shape)
    tab = tv2.stage_table((normal, (tv2.TermSpec("eikonal", "none", None, 0), ())),
                          (0.1, 0.2, 0.4), (0.5, 0.25, 2.0))
    assert (tab.n, list(tab.kind[:2]), list(tab.coef[:2]), tab.value[0]) == (2, [1, 3], [1, 2], 0.2)
    assert list(tab.inv_hmix) == [1 / (4.0 * 0.1 * 0.2), 1 / (4.0 * 0.1 * 0.4),
                                  1 / (4.0 * 0.2 * 0.4)]
    assert list(tab.inv_hh) == [1 / (0.1 * 0.1), 1 / (0.2 * 0.2), 1 / (0.4 * 0.4)]
    assert (tab.dx_min, tab.alpha, tab.beta, tab.gamma) == (0.1, 0.5, 0.25, 2.0)


# -- the slice end to end -----------------------------------------------------------------

INTEGRATORS = {"fe": (J.ForwardEuler, T.ForwardEuler), "rk2": (J.RK2, T.RK2),
               "rk3": (J.RK3, T.RK3)}


def _integrate_case(case):
    """(JAX field, port field, JAX terms, port terms, integrators) of one case."""
    extrap = lambda pkg: pkg.Extrapolation(2)
    if case == "A":
        jphi, tphi = _field((32, 32, 32), lambda m: m.torus((0.0, 0.0, 0.0), 0.5, 0.2), extrap)
        return (jphi, tphi, (J.CurvatureTerm(-0.05), J.NormalMotionTerm(0.2)),
                (T.CurvatureTerm(-0.05), T.NormalMotionTerm(0.2)), INTEGRATORS["rk3"])
    if case.startswith("B"):
        jphi, tphi = _field((24, 24, 24), _wavy, extrap)
        if case == "B_frozen":
            terms = (J.EikonalReinitializationTerm.from_initial(jphi),
                     T.EikonalReinitializationTerm.from_initial(tphi))
        else:
            terms = (J.EikonalReinitializationTerm(), T.EikonalReinitializationTerm())
        return (jphi, tphi, terms[:1], terms[1:], INTEGRATORS["rk3"])
    integ = case.split("_")[1]
    jphi, tphi = _field((20, 16, 24), lambda m: m.zalesak_sphere(),
                        lambda pkg: pkg.Periodic(), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    return (jphi, tphi, (J.AdvectionTerm(_velf), J.CurvatureTerm(-0.01)),
            (T.AdvectionTerm(_velf), T.CurvatureTerm(-0.01)), INTEGRATORS[integ])


@pytest.mark.parametrize("case", ["A", "B_frozen", "B_none", "rot_fe", "rot_rk2", "rot_rk3"])
def test_integrate_kinds_match_jax(case):
    """Config A (curvature plus normal motion on a torus), B (both eikonal
    forms on a field whose |grad| is not 1) and rotation plus curvature:
    the port's fused stepper against JAX's general path, 3 adaptive steps."""
    jphi, tphi, jterms, tterms, (jI, tI) = _integrate_case(case)
    jeq = J.LevelSetEquation(terms=jterms, ic=jphi, integrator=jI())
    teq = T.LevelSetEquation(terms=tterms, ic=tphi, integrator=tI())
    jeq.integrate(1.0, max_steps=3, fast="off")
    teq.integrate(1.0, max_steps=3)
    assert teq.last_fast_path == "fused" and teq.last_nsteps == 3
    assert teq.t == pytest.approx(jeq.t, rel=1e-14)
    _close(_np(teq.state.values), jeq.state.values, 1e-10)


def test_reinitialization_flattens_the_gradient():
    """Case B does what it is for: |grad phi| moves toward 1 near the
    interface (the JAX-parity of the trajectory is checked above)."""
    _, tphi = _field((24, 24, 24), _wavy, lambda pkg: pkg.Extrapolation(2))
    h = tphi.grid.min_spacing

    def eikonal_error(phi):
        g = T.geometry.queries.grad_norm_from_padded(phi.pad(1), phi.spacing, 1, phi.shape)
        near = phi.values.abs() < 3 * h
        return float((g[near] - 1.0).abs().mean())

    before = eikonal_error(tphi)
    for term in (T.EikonalReinitializationTerm.from_initial(tphi),
                 T.EikonalReinitializationTerm()):
        eq = T.LevelSetEquation(terms=term, ic=tphi, integrator=T.RK3())
        eq.integrate(10 * h)
        assert eq.last_fast_path == "fused"
        assert eikonal_error(eq.state) < 0.5 * before


# -- the band -------------------------------------------------------------------------------


def _band_pair(shape, center, radius, speed_field=False):
    grid = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape)
    bcs = lambda m: [m.Extrapolation(2), m.Extrapolation(1), m.Symmetry()]
    jphi = J.sample(jshapes.sphere(center, radius), J.Grid(*grid), bcs(J), dtype=jnp.float64)
    tphi = field_from_numpy(np.array(jphi.values), T.Grid(*grid), bcs(T), device="cpu")
    return J.NarrowBandField.from_field(jphi), T.NarrowBandField.from_field(tphi)


def _band_terms(case, jnb, tnb):
    if case.startswith("normal"):
        xs = np.linspace(0.0, 1.0, jnb.shape[0])[:, None, None]
        speed = np.broadcast_to(0.1 + 0.05 * xs, jnb.shape).copy()
        return ((J.NormalMotionTerm(J.MeshField(jnp.asarray(speed), jnb.grid, jnb.bcs)),),
                (T.NormalMotionTerm(T.MeshField(torch.from_numpy(speed), tnb.grid, tnb.bcs)),))
    return ((J.CurvatureTerm(-0.05), J.NormalMotionTerm(0.2)),
            (T.CurvatureTerm(-0.05), T.NormalMotionTerm(0.2)))


def _assert_band_equal(out, ref, tol):
    np.testing.assert_array_equal(_np(out.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(_np(out.compute_mask), np.asarray(ref.compute_mask))
    assert float(np.abs(_np(out.values) - np.asarray(ref.values)).max()) <= tol


@pytest.mark.parametrize("case", ["normal_fe", "normal_rk3", "curv_normal_face_rk3"])
def test_band_stepper_kinds_match_jax_dense_band(case):
    """A streamed speed on an interior band; curvature plus normal motion on
    a band that crosses the faces (K7's gates on, edge ghosts read)."""
    if case.startswith("normal"):
        jnb, tnb = _band_pair((24, 24, 32), (0.5, 0.5, 0.5), 0.25)
    else:
        jnb, tnb = _band_pair((32, 32, 32), (0.15, 0.5, 0.02), 0.3)
    jI, tI = INTEGRATORS[case.split("_")[-1]]
    jterms, tterms = _band_terms(case, jnb, tnb)
    dt = 0.2 * jnb.grid.min_spacing ** 2 if case.startswith("curv") else 0.2 * jnb.grid.min_spacing
    stepper = tband.FusedBandStepper(tterms, tnb, tI(), tiles=(8, 8, 8))
    state, t, ref = stepper.pack(tnb), 0.0, jnb
    if case.startswith("curv"):
        assert state.flags.tolist() == [1, 1]
    for _ in range(3):
        state = stepper.step(state, t, dt)
        ref, _ = jstep(jI(), jterms, ref, t, dt)
        ref = ref.update_band()
        t += dt
    assert not stepper.overflowed(state)
    _assert_band_equal(stepper.unpack(state), ref, 1e-11)


def test_band_integrate_kinds_match_jax_integrate():
    """``integrate`` on the face-crossing band: the band stepper (adaptive
    CFL over the active band, per term) against JAX's general path."""
    jnb, tnb = _band_pair((32, 32, 32), (0.15, 0.5, 0.02), 0.3)
    jterms, tterms = _band_terms("curv", jnb, tnb)
    jeq = J.LevelSetEquation(terms=jterms, ic=jnb, integrator=J.RK3())
    teq = T.LevelSetEquation(terms=tterms, ic=tnb, integrator=T.RK3())
    jeq.integrate(1.0, max_steps=3, fast="off")
    teq.integrate(1.0, max_steps=3)
    assert teq.last_fast_path == "band" and teq.last_nsteps == 3
    assert teq.t == pytest.approx(jeq.t, rel=1e-14)
    _assert_band_equal(teq.state, jeq.state, 1e-11)


def test_band_stage_kinds_match_dense_stage():
    """The plain K6 over a term list equals the dense plain K1 on the compute
    band of the dispatched tiles and keeps every other node."""
    _, tnb = _band_pair((24, 24, 32), (0.3, 0.5, 0.5), 0.25)
    shape, sp, tiles = tnb.shape, tnb.grid.spacing, (8, 8, 8)
    band = (tnb.compute_mask.to(torch.uint8) + tnb.mask.to(torch.uint8)).contiguous()
    ids, _ = bd.active_tile_ids(band, tiles, 40)
    flat, _ = bd.tile_index(ids, shape, tiles)
    speed = torch.from_numpy(np.random.default_rng(3).standard_normal(shape))
    dense = ((tv2.TermSpec("normal", "stream", None, 1), (speed,)),
             (tv2.TermSpec("curvature", "const", -0.05, 0), ()),
             (tv2.TermSpec("eikonal", "none", None, 0), ()))
    packed = ((dense[0][0], (speed.reshape(-1)[flat].contiguous(),)), dense[1], dense[2])
    P = tv2.pack_padded(tnb.values, tnb.bcs)
    target = P + 1.0
    got = bd.band_stage(P, target.clone(), ids, band, packed, (0.0, 1.0, 0.01), None, sp, shape,
                        tiles)
    assert bd.band_stage.launches == 0
    full = tv2.unpack_padded(tv2.fused_stage(P, dense, (0.0, 1.0, 0.01), None, sp, shape), shape)
    disp = bd.dispatched_cells(ids, shape, tiles)
    g = tv2.unpack_padded(got, shape)
    on = disp & (band != 0)
    assert torch.equal(g[on], full[on])
    assert torch.equal(g[disp & ~on], tv2.unpack_padded(P, shape)[disp & ~on])
    assert torch.equal(g[~disp], tv2.unpack_padded(target, shape)[~disp])


# -- gradients and what CUDA refuses ---------------------------------------------------------


def test_rollout_gradient_through_a_streamed_speed_matches_jax():
    """On the CPU the fused stepper differentiates a normal-motion rollout by
    autograd through the plain stage: gradients w.r.t. phi0 and the speed.
    A little noise on phi0 breaks the sphere's exact minmod ties, where a
    rounding difference in the forward would pick the other one-sided
    second difference and so another subgradient."""
    jphi, tphi = _field((16, 16, 16), lambda m: m.sphere((0.1, 0.0, -0.1), 0.5),
                        lambda pkg: pkg.Extrapolation(2))
    noisy = np.array(jphi.values) + 1e-3 * np.random.default_rng(5).standard_normal((16,) * 3)
    jphi, tphi = jphi.with_values(jnp.asarray(noisy)), tphi.with_values(torch.from_numpy(noisy))
    xs = np.linspace(-1.0, 1.0, 16)
    speed = np.broadcast_to(0.1 + 0.05 * xs[:, None, None] - 0.08 * xs[None, None, :],
                            (16, 16, 16)).copy()
    dt = 0.3 * jphi.grid.min_spacing

    def jloss(v, s):
        term = J.NormalMotionTerm(J.MeshField(s, jphi.grid, jphi.bcs))
        out, _ = J.rollout(J.RK3(), (term,), jphi.with_values(v), 0.0, dt, 3, fast="off")
        return jnp.sum(out.values ** 2)

    jgv, jgs = jax.grad(jloss, argnums=(0, 1))(jphi.values, jnp.asarray(speed))
    v = tphi.values.clone().requires_grad_()
    s = torch.from_numpy(speed).requires_grad_()
    term = T.NormalMotionTerm(T.MeshField(s, tphi.grid, tphi.bcs))
    out, _ = T.rollout(T.RK3(), (term,), tphi.with_values(v), 0.0, dt, 3)
    gv, gs = torch.autograd.grad((out.values ** 2).sum(), (v, s))
    _close(_np(gv), jgv, 1e-10)
    _close(_np(gs), jgs, 1e-10)
    assert float(np.abs(np.asarray(jgs)).max()) > 0


def test_cuda_refusals_name_their_roadmap_items():
    _, tphi = _field((8, 8, 8), lambda m: m.sphere((0.0, 0.0, 0.0), 0.5),
                     lambda pkg: pkg.Extrapolation(2))
    kinds = (T.CurvatureTerm(-0.05), T.NormalMotionTerm(0.2))
    # a gradient through any term list the stepper takes runs on the card
    # (K4, K3 or K3', K5): nothing names a ROADMAP item any more
    for terms in (kinds, (T.EikonalReinitializationTerm(),),
                  (T.AdvectionTerm(_velf), T.AdvectionTerm(_velf)), (T.AdvectionTerm(_velf),)):
        assert tfused.gradient_reason(terms, tphi) is None
    assert tv2.gradient_reason(((tv2.TermSpec("normal", "const", 0.2, 0), ()),)) is None
    assert "no input of the stage kernels" in tv2.gradient_reason(
        ((tv2.TermSpec("eikonal", "const", 1.0, 0), ()),))
    # update_func on the fused path: taken on CUDA and on the CPU, refreshed
    # before the CFL bound and before every stage
    seen = []
    upd = T.NormalMotionTerm(0.2, update_func=lambda s, phi, t: seen.append(t) or s)
    assert tfused.unsupported_reason((upd,), tphi, T.RK3()) is None
    eq = T.LevelSetEquation(terms=upd, ic=tphi, integrator=T.RK2())
    assert isinstance(eq._cuda_stepper(False, "auto"), tfused.FusedStepper)
    eq.integrate(0.01)
    assert eq.last_fast_path == "fused" and len(seen) == 3 * eq.last_nsteps
    # 2D and hooks
    g2 = T.Grid((0.0, 0.0), (1.0, 1.0), (8, 8))
    phi2 = T.sample(tshapes.circle((0.5, 0.5), 0.2), g2, T.Periodic(), dtype=torch.float64,
                    device="cpu")
    assert tfused.unsupported_reason(kinds, phi2, T.RK3()) is None  # a 2D field
    assert isinstance(T.LevelSetEquation(terms=kinds, ic=phi2)._cuda_stepper(False, "auto"),
                      tfused.FusedStepper)
    eq = T.LevelSetEquation(terms=kinds, ic=tphi)
    assert eq._cuda_stepper(True, "auto") is None  # hooks: the general path
    # every kind routes to the fused stepper and, on a band, to the band stepper
    assert isinstance(eq._cuda_stepper(False, "auto"), tfused.FusedStepper)
    nb = T.NarrowBandField.from_field(tphi)
    assert tband.unsupported_reason(kinds, nb, T.RK3()) is None
    assert "a curvature coefficient MeshField" in tfused.unsupported_reason(
        (T.CurvatureTerm(T.MeshField(tphi.values[None], tphi.grid, tphi.bcs)),), tphi, T.RK3())


# -- the stage's route on CUDA ---------------------------------------------------------------


def _route_case(name):
    """(terms, field) of a configuration whose stage route is checked."""
    torus = lambda: _field((12, 12, 12), lambda m: m.torus((0.0, 0.0, 0.0), 0.5, 0.2),
                           lambda pkg: pkg.Extrapolation(2))[1]
    if name == "A":
        return (T.CurvatureTerm(-0.05), T.NormalMotionTerm(0.2)), torus()
    if name == "B_frozen":
        phi = _field((12, 12, 12), _wavy, lambda pkg: pkg.Extrapolation(2))[1]
        return (T.EikonalReinitializationTerm.from_initial(phi),), phi
    if name == "B_none":
        return (T.EikonalReinitializationTerm(),), torus()
    if name == "D4":
        eq = T.models.benchmarks.config4_curvature_normal(16, dtype=torch.float64, device="cpu")
        return eq.terms, eq.state
    if name == "kinds_grad":  # curvature plus normal motion at a streamed speed
        phi = torus()
        speed = T.MeshField(0.1 + 0.05 * phi.values, phi.grid, phi.bcs)
        return (T.CurvatureTerm(-0.05), T.NormalMotionTerm(speed)), phi
    if name in ("advection_curvature", "streamed"):
        phi = torus()
        vel = T.MeshField(torch.stack([phi.values] * 3), phi.grid, phi.bcs)
        extra = (T.CurvatureTerm(-0.01),) if name == "advection_curvature" else ()
        return (T.AdvectionTerm(vel), *extra), phi
    if name == "program_table":  # a traced speed that reads axes 0, 1 and 2
        return (T.CurvatureTerm(-0.05), T.NormalMotionTerm(_speed)), torus()
    if name == "program_axis1":  # a traced speed that reads axis 1 alone
        return (T.NormalMotionTerm(lambda xs, t: 0.2 + 0.1 * xs[1]),), torus()
    if name == "rotation":  # advection only, components per column or per plane
        return (T.AdvectionTerm(_velf),), torus()
    if name == "vortex":  # advection only, a component that reads axes 0 and 1
        return (T.AdvectionTerm(lambda xs, t: (xs[1] * xs[0], -xs[0], 0.0 * xs[2])),), torus()
    eq = T.models.benchmarks.config2_zalesak(16, dtype=torch.float64, device="cpu")  # D2
    if name == "D2_untraced":  # a 2D velocity that captures a tensor: it does not trace
        one = torch.ones((), dtype=torch.float64)
        return (T.AdvectionTerm(lambda xs, t: (one * (0.5 - xs[1]), one * (xs[0] - 0.5))),), \
            eq.state
    return eq.terms, eq.state


ROUTES = {"A": "K1' march R=2", "B_frozen": "K1' march R=2", "B_none": "K1' march R=2",
          "D4": "K1' 2D per node", "kinds_grad": "K1' march R=2",
          "advection_curvature": "K1' march R=3", "program_table": "K1' per node",
          "program_axis1": "K1' per node", "rotation": "K1'' march", "vortex": "K1'' per node",
          "streamed": "K1 march", "D2": "K1'' 2D march", "D2_untraced": "K1 2D march"}


@pytest.mark.parametrize("name", list(ROUTES))
def test_stage_route(name):
    """The kernel a stepper's stage launches on CUDA, as its term table
    decides and the stepper reports it: K1''s march with reach 2 (no advection
    term) or 3, or one thread per node for a table with a program
    coefficient; K1'' per node for a velocity component that reads axis 0
    and another axis; a 2D field (D2, D4) the 2D entries (K1'' marches, K1'
    one thread per node), a 2D velocity that does not trace K1's streamed
    march, as its stage resolves it."""
    terms, phi = _route_case(name)
    stepper = tfused.FusedStepper(terms, phi, T.RK3())
    if name == "D2_untraced":
        assert stepper.entries[0][0].coef_kind == "analytic"
    assert stepper.stage_route == ROUTES[name]
    assert tv2.stage_route(stepper.stage_terms(0.0), stepper.shape) == ROUTES[name]
