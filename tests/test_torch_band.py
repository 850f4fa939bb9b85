"""The port's band path against the JAX package, on the CPU in float64: the
dispatch helpers, the plain versions of K6 (active-tile stage), K7 (gated
shell refresh) and K8 (incremental re-tube) against JAX's oracles and its
Pallas kernels in interpret mode, the ``FusedBandStepper`` against JAX's
dense band path and its own band stepper, and ``LevelSetEquation`` /
``rollout`` on a ``NarrowBandField`` (routing, overflow, the three repairs).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.core import bc as jbc
from lsm_tpu.core.narrowband import NarrowBandField as JNB
from lsm_tpu.integrators.band_fused import FusedBandStepper as JStepper
from lsm_tpu.integrators.loop import step as jstep
from lsm_tpu.models import shapes as jshapes
from lsm_tpu.ops import band_pallas as bp
from lsm_tpu.ops.weno_v2 import TermSpec as JSpec
from lsm_tpu_torch.core import bc as tbc
from lsm_tpu_torch.integrators import band_fused as tband
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.integrators import loop as tloop
from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import weno_v2 as v2
from lsm_tpu_torch.utils.checkpoint import field_from_numpy

SHAPE = (32, 32, 128)
JT = (8, 8, 128)  # the JAX kernels' tiles (B2 % 128 == 0); the port takes any
INTEG = {"fe": (J.ForwardEuler, T.ForwardEuler), "rk2": (J.RK2, T.RK2),
         "rk3": (J.RK3, T.RK3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _velf(xs, t):
    # rigid rotation about the z axis plus a drift along z; the same code
    # runs on jnp arrays and torch tensors
    return (0.5 - xs[1] + 0.0 * (xs[0] + xs[2]), xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
            0.1 + 0.0 * (xs[0] + xs[1] + xs[2]))


def _pair(shape=SHAPE, center=(0.5, 0.5, 0.5), radius=0.3, bcs=None):
    """The same sphere band in both packages (f64, CPU)."""
    bcs = bcs or [("extrap", 2)] * 3
    make = lambda m, b: m.Symmetry() if b[0] == "sym" else m.Extrapolation(b[1])
    grid = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape)
    jphi = J.sample(jshapes.sphere(center, radius), J.Grid(*grid), [make(J, b) for b in bcs],
                    dtype=jnp.float64)
    tphi = field_from_numpy(np.array(jphi.values), T.Grid(*grid), [make(T, b) for b in bcs],
                            device="cpu")
    return JNB.from_field(jphi), T.NarrowBandField.from_field(tphi)


def _combined(nb):
    return (nb.compute_mask.to(torch.uint8) + nb.mask.to(torch.uint8)).contiguous()


# -- dispatch helpers ------------------------------------------------------------------


def test_tile_ids_match_jax_without_nonzero(monkeypatch):
    jnb, tnb = _pair()

    def no_nonzero(*a, **k):
        raise AssertionError("torch.nonzero synchronises with the host")

    monkeypatch.setattr(torch, "nonzero", no_nonzero)
    act = bd.tile_activity(tnb.compute_mask, JT)
    np.testing.assert_array_equal(_np(act), np.asarray(bp.tile_activity(jnb.compute_mask, JT)))
    for cap in (512, 4):  # 4: the list overflows
        jids, jcount = bp.active_tile_ids(jnb.compute_mask, JT, cap)
        ids, count = bd.active_tile_ids(tnb.compute_mask, JT, cap)
        assert ids.dtype == torch.int32 and count.dtype == torch.int32 and ids.shape == (cap,)
        np.testing.assert_array_equal(_np(ids), np.asarray(jids))
        assert int(count) == int(jcount)
    assert int(count) > 4


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
def test_compact_ids_against_numpy(p):
    flags = np.random.default_rng(int(10 * p)).random((5, 6, 7)) < p
    want = np.flatnonzero(flags)
    for cap in (1, 30, 210, 300):
        ids, count = bd.compact_ids(torch.from_numpy(flags), cap)
        expect = np.full(cap, -1)
        expect[:min(cap, want.size)] = want[:cap]
        np.testing.assert_array_equal(_np(ids), expect)
        assert int(count) == want.size


@pytest.mark.parametrize("seed", range(6))
def test_refresh_flags_match_jax(seed):
    rng = np.random.default_rng(seed)
    act = np.zeros((4, 5, 6), bool)
    act[1:3, 1:4, 1:5] = rng.random((2, 3, 4)) < 0.5  # interior tiles
    if seed % 3:
        face = rng.integers(0, 6)
        sl = [slice(None)] * 3
        sl[face // 2] = 0 if face % 2 == 0 else -1
        act[tuple(sl)] |= rng.random(act[tuple(sl)].shape) < 0.3
    got = _np(bd.refresh_flags_from_activity(torch.from_numpy(act)))
    np.testing.assert_array_equal(got, np.asarray(bp.refresh_flags_from_activity(jnp.asarray(act))))


def test_refresh_flags_deeper_face_layers():
    """A ragged last tile shallower than the ghost sources: the gate looks
    one tile layer further in."""
    act = torch.zeros((4, 4, 4), dtype=torch.bool)
    act[1, 1, 2] = True
    assert bd.refresh_flags_from_activity(act).tolist() == [0, 0]
    assert bd.refresh_flags_from_activity(act, ((1, 1), (1, 1), (1, 2))).tolist() == [0, 1]


# -- K6 plain ----------------------------------------------------------------------------


def _stage_inputs(velocity, with_aux, marker=0.0):
    """Matching stage inputs: JAX's band layout and the port's padded one."""
    jnb, tnb = _pair()
    grid = jnb.grid
    v = np.array(jnb.values)
    a = 1.05 * v + 0.01
    jQ, tP = bp.pack_band_padded(jnb.values, jnb.bcs), v2.pack_padded(tnb.values, tnb.bcs)
    jaux = bp.pack_band_padded(jnp.asarray(a), jnb.bcs) if with_aux else None
    taux = v2.pack_padded(torch.from_numpy(a), tnb.bcs) if with_aux else None
    ids, _ = bd.active_tile_ids(tnb.compute_mask, JT, 64)
    if velocity == "stream":
        vel = 0.5 * np.random.default_rng(2).standard_normal((3, *SHAPE))
        vel[1, :, ::3] = 0.0  # tie nodes
        jspecs = ((JSpec("advection", "stream", None, 3),
                   tuple(jnp.asarray(vel[d]) for d in range(3))),)
        tspecs = ((v2.TermSpec("advection", "stream", None, 3),
                   tuple(torch.from_numpy(vel[d]) for d in range(3))),)
        flat, _ = bd.tile_index(ids, SHAPE, JT)
        u = tuple(torch.from_numpy(vel[d]).reshape(-1)[flat] for d in range(3))
    else:
        jspecs = ((JSpec("advection", "analytic", _velf, 0), ()),)
        tspecs = ((v2.TermSpec("advection", "analytic", _velf, 0), ()),)
        xs = bd.tile_coords(ids, SHAPE, JT, grid.spacing, grid.lo, torch.float64)
        u = v2.eval_components(_velf(xs, 0.2), (64, *JT), torch.float64, "cpu")
    coeffs = (0.3, 0.7, 5e-4) if with_aux else (0.0, 1.0, 1e-3)
    jout = bp.band_stage_reference(jQ, jQ + marker, None, jnb.compute_mask, jspecs, coeffs, 0.2,
                                   jaux, jnb.bcs, grid.spacing, SHAPE, grid.lo, JT)
    tout = bd.band_stage(tP, tP + marker, ids, _combined(tnb), u, coeffs, taux, grid.spacing,
                         SHAPE, JT)
    tref = bd.band_stage_reference(tP, tP + marker, _combined(tnb), tspecs, coeffs, 0.2, taux,
                                   tnb.bcs, grid.spacing, SHAPE, grid.lo, JT)
    return jnb, tnb, jQ, jspecs, coeffs, jaux, jout, tout, tref


@pytest.mark.parametrize("with_aux", [False, True], ids=["no_aux", "aux"])
@pytest.mark.parametrize("velocity", ["stream", "callable"])
def test_band_stage_plain_matches_jax_reference(velocity, with_aux):
    """The plain K6 and the port's oracle against JAX's oracle."""
    *_, jout, tout, tref = _stage_inputs(velocity, with_aux, marker=7.0)
    want = np.asarray(bp.unpack_band_padded(jout, SHAPE))
    for got in (tout, tref):
        np.testing.assert_allclose(_np(v2.unpack_padded(got, SHAPE)), want, rtol=0, atol=1e-12)


def test_band_stage_plain_matches_jax_interpret():
    """One case against JAX's Pallas band stage in interpret mode, inactive
    tiles included (they keep the target's marker values)."""
    jnb, tnb, jQ, jspecs, coeffs, _, _, tout, _ = _stage_inputs("callable", False, marker=7.0)
    ids, _ = bp.active_tile_ids(jnb.compute_mask, JT, 64)
    jout = bp.band_stage(jQ, jQ + 7.0, ids, jnb.compute_mask, jspecs, coeffs, 0.2, None,
                         jnb.bcs, jnb.grid.spacing, SHAPE, jnb.grid.lo, JT, interpret=True)
    got, want = _np(v2.unpack_padded(tout, SHAPE)), np.asarray(bp.unpack_band_padded(jout, SHAPE))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    act = np.asarray(bp.tile_activity(jnb.compute_mask, JT))
    cells = np.repeat(np.repeat(np.repeat(act, 8, 0), 8, 1), 128, 2)
    np.testing.assert_array_equal(got[~cells], np.asarray(jnb.values)[~cells] + 7.0)


# -- K7 plain ----------------------------------------------------------------------------

K7_BCS = {
    "symmetry": (jbc.Symmetry(), tbc.Symmetry()),
    "extrap0": (jbc.Extrapolation(0), tbc.Extrapolation(0)),
    "extrap2": (jbc.Extrapolation(2), tbc.Extrapolation(2)),
    "periodic": (jbc.Periodic(), tbc.Periodic()),
    "mixed": ([(jbc.Symmetry(), jbc.Extrapolation(1)), jbc.Extrapolation(3),
               (jbc.Extrapolation(2), jbc.Symmetry())],
              [(tbc.Symmetry(), tbc.Extrapolation(1)), tbc.Extrapolation(3),
               (tbc.Extrapolation(2), tbc.Symmetry())]),
}


@pytest.mark.parametrize("flags", [(1, 1), (1, 0), (0, 0), (0, 1)],
                         ids=lambda f: f"flags{f[0]}{f[1]}")
@pytest.mark.parametrize("name", list(K7_BCS))
def test_k7_plain_matches_jax(name, flags):
    jb, tb = jbc.normalize_bcs(K7_BCS[name][0], 3), tbc.normalize_bcs(K7_BCS[name][1], 3)
    shape = (28, 16, 128)
    n0, n1, n2 = shape
    vals = np.random.default_rng(1).standard_normal(shape)
    P = bp.pack_band_padded(jnp.asarray(vals), jb)
    Pd = (P.at[0:8].add(7.0).at[-8:].add(-3.0).at[:, 5:8].add(2.0).at[:, -8:-5].add(1.0)
          .at[:, :, 125:128].add(4.0).at[:, :, -131:-125].add(5.0))  # scribbled shells
    ref = bp.refresh_band_ghosts(Pd, jb, shape)
    w = np.s_[5:11 + n0, 5:11 + n1, 125:131 + n2]  # the 3-ghost window
    before, full = np.array(Pd[w]), np.asarray(ref[w])
    want = before.copy()
    if flags[0]:  # axes 0 and 1: the whole window except the axis-2 shells
        want[:, :, 3:3 + n2] = full[:, :, 3:3 + n2]
    if flags[1]:
        want[:, :, :3], want[:, :, 3 + n2:] = full[:, :, :3], full[:, :, 3 + n2:]
    if flags == (0, 1):  # the axis-2 ghosts of the scribbled axis-0/1 ghost rows read them
        want = np.asarray(bp.refresh_band_ghosts_fast(Pd, jb, shape, interpret=True,
                                                      flags=jnp.asarray(flags, jnp.int32))[w])
        assert not np.array_equal(want[:, :, :3], full[:, :, :3])
    got = bd.refresh_band_ghosts_fast(torch.from_numpy(before), tb, shape,
                                      torch.tensor(flags, dtype=torch.int32))
    # corner ghosts extrapolated three times reach ~1e3: rounding, relative
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-14 * max(np.abs(want).max(), 1.0))
    if flags == (0, 0):
        np.testing.assert_array_equal(_np(got), before)


# -- K8 plain ----------------------------------------------------------------------------


def test_k8_plain_matches_jax_interpret_and_full_retube():
    jnb, tnb = _pair()
    # the interface moves by about 1.5 cells: the new band differs from the old
    _, moved = _pair(center=(0.55, 0.5, 0.5))
    band = _combined(tnb)
    P = v2.pack_padded(moved.values, tnb.bcs)
    act = bd.tile_activity(band, JT)
    cand, ncand = bd.compact_ids(tband.box_dilate(act, 1), 16)
    assert int(ncand) <= 16
    flags = bd.band_retube_incremental(P, band, cand, 3, 3, SHAPE, JT, ncand)
    # JAX's kernel, its band layout and combined mask in phi's dtype
    jQ = bp.pack_band_padded(jnp.asarray(_np(moved.values)), jnb.bcs)
    jband = (bp.pack_band_mask(jnb.compute_mask, jQ.dtype) + bp.pack_band_mask(jnb.mask, jQ.dtype))
    jcand = jnp.asarray(_np(cand))
    jnew, jflags = bp.band_retube_incremental(jQ, jband, jcand, 3, 3, SHAPE, JT, interpret=True)
    np.testing.assert_array_equal(_np(band), np.asarray(bp.unpack_band_padded(jnew, SHAPE)))
    np.testing.assert_array_equal(_np(flags) != 0, np.asarray(jflags) > 0)
    # exact against the full re-tube, and the band really moved
    full = bd.retube_full(moved.values, _combined(tnb), 3, 3)
    np.testing.assert_array_equal(_np(band), _np(full))
    assert not torch.equal(band, _combined(tnb))
    assert flags.dtype == torch.int32 and flags.shape == (16,)


# -- the stepper -------------------------------------------------------------------------


def _dense_band_run(integ, jnb, dt, steps, velf=_velf):
    ref, t = jnb, 0.0
    for _ in range(steps):
        ref, _ = jstep(integ(), (J.AdvectionTerm(velf),), ref, t, dt)
        ref = ref.update_band()
        t += dt
    return ref


def _port_run(integ, tnb, dt, steps, velf=_velf, **kw):
    stepper = tband.FusedBandStepper((T.AdvectionTerm(velf),), tnb, integ(), **kw)
    state, t = stepper.pack(tnb), 0.0
    for _ in range(steps):
        state = stepper.step(state, t, dt)
        t += dt
    assert not stepper.overflowed(state)
    return stepper, state, stepper.unpack(state)


def _assert_band_equal(out, ref, tol=1e-11):
    np.testing.assert_array_equal(_np(out.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(_np(out.compute_mask), np.asarray(ref.compute_mask))
    assert float(np.abs(_np(out.values) - np.asarray(ref.values)).max()) <= tol


@pytest.mark.parametrize("integ", list(INTEG))
def test_stepper_matches_jax_dense_band(integ):
    jI, tI = INTEG[integ]
    jnb, tnb = _pair()
    dt = 0.2 * jnb.grid.min_spacing
    _, state, out = _port_run(tI, tnb, dt, 3)
    _assert_band_equal(out, _dense_band_run(jI, jnb, dt, 3))
    assert 0 < int(state.count) <= 64


def test_stepper_rk3_matches_jax_band_stepper_interpret():
    jnb, tnb = _pair()
    dt = 0.2 * jnb.grid.min_spacing
    js = JStepper((J.AdvectionTerm(_velf),), jnb, J.RK3(), tiles=JT, interpret=True)
    jstate, t = js.pack(jnb), 0.0
    for _ in range(3):
        jstate = js.step(jstate, t, dt)
        t += dt
    _, _, out = _port_run(T.RK3, tnb, dt, 3)
    _assert_band_equal(out, js.unpack(jstate))


@pytest.mark.parametrize("case", ["interior", "faces"])
def test_refresh_gates_on_interior_and_face_bands(case):
    """An interface inside the grid gates the whole shell refresh off; one
    that crosses faces gates it on; both match the dense band path. The
    gates see whole tiles, so the tiles are small enough for this grid."""
    if case == "interior":
        jnb, tnb = _pair((40, 40, 128), radius=0.12)
        integ, want = (J.RK2, T.RK2), [0, 0]
    else:
        jnb, tnb = _pair((32, 32, 64), center=(0.15, 0.5, 0.02), radius=0.25,
                         bcs=[("extrap", 2), ("extrap", 1), ("sym", 0)])
        integ, want = (J.ForwardEuler, T.ForwardEuler), [1, 1]
    dt = 0.2 * jnb.grid.min_spacing
    tiles = (8, 8, 32)
    stepper = tband.FusedBandStepper((T.AdvectionTerm(_velf),), tnb, integ[1](), tiles=tiles)
    state = stepper.pack(tnb)
    assert state.flags.tolist() == want
    if case == "interior":
        assert int(state.count) < stepper.total  # tiles off the band are skipped
    _, _, out = _port_run(integ[1], tnb, dt, 3, tiles=tiles)
    _assert_band_equal(out, _dense_band_run(integ[0], jnb, dt, 3))


def test_tile_choices_give_identical_results():
    _, tnb = _pair((32, 32, 64), center=(0.15, 0.5, 0.02), radius=0.25,
                   bcs=[("extrap", 2), ("extrap", 1), ("sym", 0)])
    dt = 0.2 * tnb.grid.min_spacing
    outs = [_port_run(T.RK3, tnb, dt, 3, tiles=tiles)[2] for tiles in ((8, 8, 32), (16, 8, 8))]
    assert torch.equal(outs[0].values, outs[1].values)
    assert torch.equal(outs[0].mask, outs[1].mask)
    assert torch.equal(outs[0].compute_mask, outs[1].compute_mask)


def test_shallow_tiles_take_the_full_retube():
    jnb, tnb = _pair()
    dt = 0.2 * jnb.grid.min_spacing
    stepper, _, out = _port_run(T.RK2, tnb, dt, 3, tiles=(4, 8, 32))
    assert not stepper.incremental
    _assert_band_equal(out, _dense_band_run(J.RK2, jnb, dt, 3))


def test_shallow_tiles_refused_on_cuda(monkeypatch):
    """On CUDA the re-tube is K8 alone: tiles shallower than its reach
    (1 + nlayers + COMPUTE_HALO = 7 here) raise instead of taking the
    full re-tube, which is plain torch over the whole grid."""
    _, tnb = _pair()
    monkeypatch.setattr(T.NarrowBandField, "device", property(lambda self: torch.device("cuda")))
    with pytest.raises(ValueError, match="reach 1 \\+ nlayers \\+ COMPUTE_HALO = 7"):
        tband.FusedBandStepper((T.AdvectionTerm(_velf),), tnb, T.RK2(), tiles=(4, 8, 32))


def test_retube_every_bounds():
    _, tnb = _pair()
    term = T.AdvectionTerm(_velf)
    assert tband.FusedBandStepper(term, tnb, T.RK3(), retube_every=6).retube_every == 6
    for bad in (0, 7):  # cfl 0.5, margin 3: at most 6 steps between re-tubes
        with pytest.raises(ValueError, match="safe range"):
            tband.FusedBandStepper(term, tnb, T.RK3(), retube_every=bad)


def test_unpack_warns_on_dispatch_overflow():
    _, tnb = _pair()
    stepper = tband.FusedBandStepper((T.AdvectionTerm(_velf),), tnb, T.ForwardEuler())
    state = stepper.pack(tnb)
    bad = state._replace(count=torch.tensor(stepper.capacity + 1, dtype=torch.int32))
    with pytest.warns(RuntimeWarning, match="overflow"):
        stepper.unpack(bad)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        stepper.unpack(state)


def _tiny_capacity(monkeypatch, capacity=2):
    """The first band stepper of the run gets ``capacity`` slots; the ones
    ``regrow`` builds keep theirs. Returns the list of capacities built."""
    made = []
    init = tband.FusedBandStepper.__init__

    def patched(self, *a, capacity=None, **k):
        init(self, *a, capacity=capacity if made else 2, **k)
        made.append(self.capacity)

    monkeypatch.setattr(tband.FusedBandStepper, "__init__", patched)
    return made


def test_integrate_regrows_an_overflowing_dispatch_list(monkeypatch):
    _, tnb = _pair()
    runs = {}
    for tiny in (False, True):
        made = _tiny_capacity(monkeypatch) if tiny else []
        eq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tnb, integrator=T.RK2())
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no overflow warning: nothing was skipped
            eq.integrate(0.05)
        runs[tiny] = eq
        monkeypatch.undo()
    assert made[0] == 2 and len(made) >= 2 and made[-1] > 2
    a, b = runs[False], runs[True]
    assert a.last_fast_path == b.last_fast_path == "band" and a.last_nsteps == b.last_nsteps
    assert torch.equal(a.state.values, b.state.values)
    assert torch.equal(a.state.mask, b.state.mask)


# -- the equation and the rollout --------------------------------------------------------


@pytest.mark.parametrize("integ", ["fe", "rk3"])
def test_integrate_band_matches_jax_integrate(integ):
    """``integrate`` on a band: the port's band stepper against JAX's
    general path (its fast path is for compiled backends), equal steps."""
    jI, tI = INTEG[integ]
    jnb, tnb = _pair()
    jsteps = []
    jeq = J.LevelSetEquation(terms=J.AdvectionTerm(_velf), ic=jnb, integrator=jI())
    jeq.integrate(0.04, posthook=lambda eq: jsteps.append(eq.t))
    teq = T.LevelSetEquation(terms=T.AdvectionTerm(_velf), ic=tnb, integrator=tI())
    teq.integrate(0.04)
    assert teq.last_fast_path == "band" and teq.last_nsteps == len(jsteps) >= 3
    assert teq.t == jeq.t == 0.04
    assert isinstance(teq.state, T.NarrowBandField)
    _assert_band_equal(teq.state, jeq.state, tol=1e-10)


def _translate(xs, t):
    return (1.0 + 0.0 * (xs[0] + xs[1] + xs[2]), 0.0 * (xs[0] + xs[1] + xs[2]),
            0.0 * (xs[0] + xs[1] + xs[2]))


def test_general_loop_retubes():
    """Repair: the general host loop re-tubes after every step, as JAX's."""
    jnb, tnb = _pair((24, 24, 24), radius=0.25)
    jeq = J.LevelSetEquation(terms=J.AdvectionTerm(_translate), ic=jnb, integrator=J.RK2())
    teq = T.LevelSetEquation(terms=T.AdvectionTerm(_translate), ic=tnb, integrator=T.RK2())
    jeq.integrate(0.1, fast="off")
    teq.integrate(0.1, fast="off")
    assert teq.last_fast_path is None
    _assert_band_equal(teq.state, jeq.state, tol=1e-10)
    assert not torch.equal(teq.state.mask, tnb.mask)  # the band followed the interface


@pytest.mark.parametrize("integ", ["fe", "rk3"])
def test_tiles_leaving_the_band_match_jax_dense_band(integ):
    """A translated band whose trailing tiles leave the active set. Those
    tiles are dispatched once more, so every buffer of the rotation takes
    their current values: the stepper keeps matching JAX's dense band
    path after they left."""
    jI, tI = INTEG[integ]
    jnb, tnb = _pair((32, 32, 32), center=(0.63, 0.5, 0.5), radius=0.2)
    dt = 0.25 * jnb.grid.min_spacing
    stepper = tband.FusedBandStepper((T.AdvectionTerm(_translate),), tnb, tI(), tiles=(8, 8, 8))
    state, t, left = stepper.pack(tnb), 0.0, []
    for k in range(5):
        prev = state.act
        state = stepper.step(state, t, dt)
        t += dt
        if bool((prev & ~state.act).any()):
            left.append(k)
    assert left and left[0] < 3  # steps were taken after a tile left
    _assert_band_equal(stepper.unpack(state), _dense_band_run(jI, jnb, dt, 5, velf=_translate))


def test_dense_stepper_refuses_a_band_field():
    """Repair: the dense fused stepper would step a band densely, unmasked."""
    _, tnb = _pair()
    term = T.AdvectionTerm(_velf)
    reason = tfused.unsupported_reason((term,), tnb, T.RK3())
    assert reason is not None and "NarrowBandField" in reason
    with pytest.raises(NotImplementedError, match="dense"):
        tfused.FusedStepper((term,), tnb, T.RK3())
    assert tfused.unsupported_reason((term,), T.MeshField(tnb.values, tnb.grid, tnb.bcs),
                                     T.RK3()) is None


def test_band_routing_names_roadmap_items():
    _, tnb = _pair((16, 16, 16))
    vel = T.AdvectionTerm(_velf)
    # a sum of two advection terms now routes to the band stepper; an object
    # that is no term kind is refused with a reason that says so
    assert tband.unsupported_reason((vel, vel), tnb, T.RK3()) is None
    assert isinstance(T.LevelSetEquation(terms=(vel, vel), ic=tnb)._cuda_stepper(False, "auto"),
                      tband.FusedBandStepper)
    cases = [
        ((vel, object()), tnb, "no term kind"),
        ((T.AdvectionTerm(_velf, "upwind"),), tnb, "general path"),
    ]
    for terms, nb, item in cases:
        assert item in tband.unsupported_reason(terms, nb, T.RK3())
        with pytest.raises(NotImplementedError, match=item.replace("(", r"\(").replace(")", r"\)")):
            tband.FusedBandStepper(terms, nb, T.RK3())
    # on CUDA the upwind scheme and an object that is no term kind take the
    # general path (None); Extrapolation(8) takes the band stepper (the ghost
    # kernels' table route), equal to JAX's dense band path; a 2D band takes
    # the band stepper (its 2D entries)
    for terms, nb, item in cases:
        assert T.LevelSetEquation(terms=terms, ic=nb)._cuda_stepper(False, "auto") is None
    jnb8, tnb8 = _pair((16, 16, 16), bcs=[("extrap", 8)] * 3)
    assert tband.unsupported_reason((vel,), tnb8, T.RK3()) is None
    assert isinstance(T.LevelSetEquation(terms=vel, ic=tnb8)._cuda_stepper(False, "auto"),
                      tband.FusedBandStepper)
    dt = 0.2 * jnb8.grid.min_spacing
    _, _, out = _port_run(T.RK3, tnb8, dt, 2)
    _assert_band_equal(out, _dense_band_run(J.RK3, jnb8, dt, 2))
    teq = T.LevelSetEquation(terms=vel, ic=tnb8, integrator=T.RK3())
    teq.integrate(2 * dt, dt_max=dt)
    assert teq.last_fast_path == "band" and teq.last_nsteps == 2
    torch.testing.assert_close(teq.state.values, out.values, rtol=0, atol=1e-13)
    grid2 = T.Grid((0.0, 0.0), (1.0, 1.0), (16, 16))
    nb2 = T.NarrowBandField(torch.linspace(-1, 1, 16, dtype=torch.float64)[:, None].expand(16, 16)
                            .contiguous(), grid2, T.Extrapolation(1))
    vel2 = T.AdvectionTerm(lambda xs, t: (-xs[1], xs[0]))
    assert tband.unsupported_reason((vel2,), nb2, T.RK3()) is None
    stepper = T.LevelSetEquation(terms=vel2, ic=nb2)._cuda_stepper(False, "auto")
    assert isinstance(stepper, tband.FusedBandStepper) and stepper.tiles == tband.TILES_2D
    # hooks and fast="off" take the general path on CUDA too (K10 over the
    # band's dense values, then the plain re-tube)
    eq = T.LevelSetEquation(terms=vel, ic=tnb)
    assert eq._cuda_stepper(True, "auto") is None
    assert eq._cuda_stepper(False, "off") is None
    assert T.LevelSetEquation(terms=vel, ic=nb2)._cuda_stepper(True, "auto") is None
    # on the CPU, hooks and other configurations take the general path
    seen = []
    eq.integrate(0.01, posthook=lambda e: seen.append(e.t))
    assert eq.last_fast_path is None and seen and isinstance(eq.state, T.NarrowBandField)
    eq2 = T.LevelSetEquation(terms=T.AdvectionTerm(_velf, "upwind"), ic=tnb)
    eq2.integrate(0.01)
    assert eq2.last_fast_path is None


def test_rollout_on_a_band_matches_jax_and_the_band_stepper():
    """CPU: the general path under autograd, re-tubing each step (JAX's
    general rollout); the card's band rollout (the band stepper, here on its
    plain versions) gives the same band and the same gradient."""
    jnb, tnb = _pair((24, 24, 32), radius=0.25)
    dt = 0.2 * jnb.grid.min_spacing
    jout, _ = J.rollout(J.RK3(), (J.AdvectionTerm(_velf),), jnb, 0.0, dt, 3, fast="off")
    v = tnb.values.clone().requires_grad_()
    tout, _ = T.rollout(T.RK3(), (T.AdvectionTerm(_velf),), tnb.with_values(v, mask_update=False),
                        0.0, dt, 3)
    assert isinstance(tout, T.NarrowBandField)
    _assert_band_equal(tout, jout)
    (g,) = torch.autograd.grad((tout.values ** 2).sum(), v)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    band_out, _ = tloop._band_rollout(T.RK3(), (T.AdvectionTerm(_velf),), tnb, 0.0, dt, 3)
    _assert_band_equal(band_out, jout)
    w = tnb.values.clone().requires_grad_()
    bout, _ = tloop._band_rollout(T.RK3(), (T.AdvectionTerm(_velf),),
                                  tnb.with_values(w, mask_update=False), 0.0, dt, 3)
    _assert_band_equal(bout, jout)
    (gb,) = torch.autograd.grad((bout.values ** 2).sum(), w)
    assert float((gb - g).abs().max()) <= 1e-12 * max(float(g.abs().max()), 1.0)


def test_band_stepper_refuses_a_velocity_that_needs_a_gradient():
    """A streamed velocity or a callable closing over a parameter that
    requires a gradient is no longer refused: the band stepper's stages are
    differentiable (``band_step_stage``) and the gradient reaches the dense
    velocity and the parameter, as the general band path's does; without a
    gradient the same rollout writes its buffers in place."""
    _, tnb = _pair((24, 24, 32), radius=0.25)
    dt = 0.2 * tnb.grid.min_spacing
    theta = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    stream = torch.zeros((3, 24, 24, 32), dtype=torch.float64)
    stream[0] = 1.0
    stream[2] = 0.1
    stream.requires_grad_()
    terms = {"callable": (T.AdvectionTerm(lambda xs, t: tuple(theta * c for c in _velf(xs, t))),
                          theta),
             "streamed": (T.AdvectionTerm(stream), stream)}
    for term, param in terms.values():
        out, _ = tloop._band_rollout(T.RK3(), (term,), tnb, 0.0, dt, 1)
        (g,) = torch.autograd.grad((out.values ** 2).sum(), param)
        ref, _ = T.rollout(T.RK3(), (term,), tnb, 0.0, dt, 1)  # the CPU's general path
        (gr,) = torch.autograd.grad((ref.values ** 2).sum(), param)
        assert float(gr.abs().max()) > 0
        assert float((g - gr).abs().max()) <= 1e-12 * max(float(gr.abs().max()), 1.0)
        with torch.no_grad():  # nothing needs a gradient: the forward runs
            out, _ = tloop._band_rollout(T.RK3(), (term,), tnb, 0.0, dt, 1)
        assert bool(torch.isfinite(out.values).all())
