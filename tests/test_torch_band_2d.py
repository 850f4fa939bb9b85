"""The port's 2D narrow band against the JAX package, on the CPU in float64.

JAX runs a 2D band through its 3D band kernels on the ``(1, n0, n1)``
embedding; the port keeps the band on its own ``(n0+6, n1+6)`` layout with
``(B0, B1)`` tiles and runs the 2D entries of K6, K7 and K8 (here their
plain versions). Checked: the 2D tile algebra against the 3D one on the
embedding; the 2D plain versions against the 3D plain versions on the
embedding; the stepper against JAX's band stepper (Pallas in interpret mode)
and JAX's general path with ``update_band`` on ``Test2DBandPath``'s setup;
``integrate``, ``rollout`` and its gradient; the eikonal smoothing spacing
(the port's repair of JAX's embedding); routing and errors; checkpoints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.core import bc as jbc
from lsm_tpu.core.narrowband import NarrowBandField as JNB
from lsm_tpu.integrators import loop as jloop
from lsm_tpu.integrators.band_fused import FusedBandStepper as JStepper
from lsm_tpu.utils import checkpoint as jck
from lsm_tpu_torch.integrators import band_fused as tband
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.integrators import loop as tloop
from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import weno_v2 as v2
from lsm_tpu_torch.utils import checkpoint as tck

SHAPE = (64, 128)  # JAX's Test2DBandPath
LO, HI = (-1.0, -1.0), (1.0, 1.0)
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _rot(xs, t):
    return (-xs[1], xs[0])


def _pair(shape=SHAPE, center=(0.0, 0.0), radius=0.5, bc="extrap2", nlayers=4, lo=LO, hi=HI):
    """The same circle band in both packages (f64, CPU)."""
    make = {"extrap2": lambda m: m.Extrapolation(2), "extrap1": lambda m: m.Extrapolation(1),
            "symmetry": lambda m: m.Symmetry()}[bc]
    cx, cy = center
    jphi = J.sample(lambda X, Y: jnp.sqrt((X - cx) ** 2 + (Y - cy) ** 2) - radius,
                    J.Grid(lo, hi, shape), make(J), dtype=jnp.float64)
    tphi = tck.field_from_numpy(np.array(jphi.values), T.Grid(lo, hi, shape), make(T),
                                device="cpu")
    return JNB.from_field(jphi, nlayers=nlayers), T.NarrowBandField.from_field(tphi, nlayers)


def _close(got, want, tol=TOL):
    """Values within ``tol * max(|want|, 1)`` and equal active masks."""
    np.testing.assert_array_equal(_np(got.mask), np.asarray(want.mask))
    want_v = np.asarray(want.values)
    err = np.abs(_np(got.values) - want_v).max()
    assert err <= tol * max(np.abs(want_v).max(), 1.0), err


def _port_steps(terms, nb, integrator, dt, nsteps, **kw):
    stepper = tband.FusedBandStepper(terms, nb, integrator, **kw)
    state = stepper.pack(nb)
    for k in range(nsteps):
        state = stepper.step(state, k * dt, dt)
    return stepper, state, stepper.unpack(state)


def _jax_general(terms, nb, integrator, dt, nsteps):
    out = nb
    for k in range(nsteps):
        out, _ = jloop.step(integrator, terms, out, float(k * dt), float(dt))
        out = out.update_band()
    return out


def _jax_band(terms, nb, integrator, dt, nsteps):
    st = JStepper(terms, nb, integrator, interpret=True)
    state = st.pack(nb)
    for k in range(nsteps):
        state = st.step(state, k * dt, jnp.asarray(dt))
    return st.unpack(state)


# -- the 2D tile algebra ---------------------------------------------------------------


@pytest.mark.parametrize("tiles", [(16, 16), (8, 32), (7, 9)])
def test_tile_algebra_matches_the_embedding(tiles):
    """Activity, ids, per-slot indices and coordinates and the dispatched
    cells of a 2D band equal the 3D functions' on the ``(1, n0, n1)``
    embedding with ``(1, B0, B1)`` tiles (the same flat tile ids)."""
    _, tnb = _pair()
    cm, shape = tnb.compute_mask, tnb.shape
    act = bd.tile_activity(cm, tiles)
    act3 = bd.tile_activity(cm[None], (1, *tiles))
    assert act.shape == bd.tile_grid(shape, tiles) and torch.equal(act, act3[0])
    cap = int(act.sum()) + 3
    ids, count = bd.active_tile_ids(cm, tiles, cap)
    ids3, count3 = bd.active_tile_ids(cm[None], (1, *tiles), cap)
    assert torch.equal(ids, ids3) and int(count) == int(count3) == cap - 3
    flat, valid = bd.tile_index(ids, shape, tiles)
    flat3, valid3 = bd.tile_index(ids, (1, *shape), (1, *tiles))
    assert flat.shape == (cap, *tiles)
    assert torch.equal(flat, flat3[:, 0]) and torch.equal(valid, valid3[:, 0])
    assert not bool(valid[-1].any())  # an empty slot
    xs = bd.tile_coords(ids, shape, tiles, tnb.spacing, tnb.grid.lo, torch.float64)
    xs3 = bd.tile_coords(ids, (1, *shape), (1, *tiles), (1.0, *tnb.spacing),
                         (0.0, *tnb.grid.lo), torch.float64)
    for a, b in zip(xs, xs3[1:]):
        assert torch.equal(a, b[:, 0])
    cells = bd.dispatched_cells(ids, shape, tiles)
    assert torch.equal(cells, bd.dispatched_cells(ids, (1, *shape), (1, *tiles))[0])
    assert bool(cells[cm].all())  # every compute-band node lies in a dispatched tile


@pytest.mark.parametrize("faces", [(), ("x0",), ("y1",), ("x1", "y0")])
def test_refresh_flags_2d(faces):
    """``flags[0]`` is on when a visited tile touches a face of axis 0,
    ``flags[1]`` when one touches a face of axis 1 or ``flags[0]`` is on."""
    act = torch.zeros((5, 6), dtype=torch.bool)
    act[2, 3] = True
    where = {"x0": (0, 2), "x1": (-1, 2), "y0": (2, 0), "y1": (2, -1)}
    for f in faces:
        act[where[f]] = True
    got = bd.refresh_flags_from_activity(act).tolist()
    f0 = any(f.startswith("x") for f in faces)
    assert got == [int(f0), int(f0 or any(f.startswith("y") for f in faces))]
    # a ghost source two tile layers in: a tile one layer in turns the gate on
    act = torch.zeros((5, 6), dtype=torch.bool)
    act[1, 3] = True
    assert bd.refresh_flags_from_activity(act, ((2, 1), (1, 1))).tolist() == [1, 1]
    assert bd.refresh_flags_from_activity(act).tolist() == [0, 0]


# -- the plain versions against the 3D ones on the embedding ---------------------------


def _embed(P2):
    """A 2D padded buffer as the ``(1, n0, n1)`` embedding's: the axis-0
    ghosts of ``Extrapolation(0)`` are copies of the one node."""
    return P2[None].expand(2 * v2.GHOST + 1, *P2.shape).contiguous()


def _plain_cases(nb, rng):
    shape = nb.shape
    speed = rng.standard_normal(shape)
    speed[:, ::4] = 0.0  # ties
    vel = rng.standard_normal((2, *shape))
    sign = np.sign(_np(nb.values))
    return {
        "advection streamed": (T.AdvectionTerm(T.MeshField(torch.from_numpy(vel), nb.grid)),),
        "rotation program": (T.AdvectionTerm(_rot),),
        "3-term sum": (T.NormalMotionTerm(T.MeshField(torch.from_numpy(speed), nb.grid)),
                       T.CurvatureTerm(-0.05), T.EikonalReinitializationTerm()),
        "eikonal frozen sign": (T.EikonalReinitializationTerm(
            T.MeshField(torch.from_numpy(sign), nb.grid)),),
        "normal callable": (T.NormalMotionTerm(lambda xs, t: 0.2 + 0.1 * xs[0] * xs[1] + t),),
    }


@pytest.mark.parametrize("case", ["advection streamed", "rotation program", "3-term sum",
                                  "eikonal frozen sign", "normal callable"])
def test_plain_stage_2d_matches_the_embedding(case):
    """K6's 2D plain version (the 2D stencils) against K6's 3D plain version
    on the embedding (JAX's function), on the stepper's tile-packed terms,
    with aux: bit for bit but for the curvature's sums of exact zeros,
    within 1e-14."""
    rng = np.random.default_rng(11)
    _, nb = _pair(nlayers=3)
    terms = _plain_cases(nb, rng)[case]
    stepper = tband.FusedBandStepper(terms, nb, T.RK3())
    state = stepper.pack(nb)
    packed = stepper.stage_terms(state, 0.3)
    shape, tiles, sp = nb.shape, stepper.tiles, stepper.spacing
    P = state.bufs[0]
    A = v2.pack_padded(nb.values + 0.01 * torch.from_numpy(rng.standard_normal(shape)), nb.bcs)
    target = P + torch.from_numpy(rng.standard_normal(P.shape))
    where = v2.Where(nb.grid.lo, None, 0.3)
    coeffs = (0.75, 0.25, 2.5e-3)
    got = bd.band_stage_plain(P, target.clone(), state.ids, state.band, packed, coeffs, A, sp,
                              shape, tiles, where)
    sp3, where3 = bd.embedding_2d(sp, where)
    packed3 = tuple((spec, tuple(a[:, None] for a in arrs)) for spec, arrs in packed)
    ref = bd.band_stage_plain(_embed(P), _embed(target), state.ids, state.band[None], packed3,
                              coeffs, _embed(A), sp3, (1, *shape), (1, *tiles), where3)
    ref = ref[v2.GHOST]
    err = float((got - ref).abs().max())
    assert err <= 1e-14 * max(float(ref.abs().max()), 1.0)
    if case != "3-term sum":
        assert torch.equal(got, ref)
    # the dispatched compute band changed; every other node kept its value
    cells = bd.dispatched_cells(state.ids, shape, tiles)
    g, t0 = v2.unpack_padded(got, shape), v2.unpack_padded(target, shape)
    assert torch.equal(g[~cells], t0[~cells])
    assert torch.equal(g[cells & (state.band == 0)], v2.unpack_padded(P, shape)[
        cells & (state.band == 0)])


@pytest.mark.parametrize("flags", [(1, 1), (0, 1), (0, 0)])
@pytest.mark.parametrize("bc", ["periodic", "symmetry", "extrap0", "extrap2", "mixed"])
def test_plain_refresh_2d(bc, flags):
    """K7's 2D plain version: the middle plane of K7's 3D plain version on
    the ``(1, n0, n1)`` embedding (the same gates), bit for bit; with both
    gates on, the ghosts JAX's ``pad_ghost`` builds from the interior; with
    ``flags[0]`` off, the axis-0 ghost rows keep their values and the axis-1
    ghosts are built from them; with both off, nothing changes."""
    bcs = {"periodic": (J.Periodic(), T.Periodic()), "symmetry": (J.Symmetry(), T.Symmetry()),
           "extrap0": (J.Extrapolation(0), T.Extrapolation(0)),
           "extrap2": (J.Extrapolation(2), T.Extrapolation(2)),
           "mixed": ([(J.Symmetry(), J.Extrapolation(1)), (J.Extrapolation(3), J.Symmetry())],
                     [(T.Symmetry(), T.Extrapolation(1)), (T.Extrapolation(3), T.Symmetry())])}
    jb, tb = bcs[bc]
    shape, g = (20, 28), v2.GHOST
    rng = np.random.default_rng(len(bc))
    Q = torch.from_numpy(rng.standard_normal(v2.padded_shape(shape)))
    tbcs = T.normalize_bcs(tb, 2)
    got = bd.refresh_band_ghosts_plain(Q.clone(), tbcs, shape,
                                       torch.tensor(flags, dtype=torch.int32))
    interior = _np(Q[g:-g, g:-g])
    ref = bd.refresh_band_ghosts_plain(_embed(Q), ((T.Extrapolation(0),) * 2, *tbcs),
                                       (1, *shape), torch.tensor(flags, dtype=torch.int32))
    assert torch.equal(got, ref[g])
    if flags == (1, 1):  # K2's full refresh; JAX's extrapolation sums round otherwise
        assert torch.equal(got, v2.refresh_ghosts_plain(Q.clone(), tbcs, shape))
        want = np.asarray(jbc.pad_ghost(jnp.asarray(interior), jbc.normalize_bcs(jb, 2), g))
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-13 * np.abs(want).max())
    elif flags == (0, 1):
        want = v2.refresh_axis_plain(Q.clone(), tbcs, shape, 1)
        assert torch.equal(got, want) and torch.equal(got[:g, g:-g], Q[:g, g:-g])
    else:
        assert torch.equal(got, Q)


def test_plain_retube_2d_matches_the_full_retube():
    """K8's 2D plain version on the candidate tiles (the active tiles and
    their neighbours) after the interface has moved across a tile boundary:
    the full re-tube's mask, as JAX's ``update_band`` gives it."""
    jnb, tnb = _pair(nlayers=3)
    tiles = tband.default_tiles(3, 2)
    band = (tnb.compute_mask.to(torch.uint8) + tnb.mask.to(torch.uint8)).contiguous()
    act = bd.tile_activity(band, tiles)
    h = tnb.grid.spacing[0]
    _, moved = _pair(center=(5.0 * h, -4.0 * h), nlayers=3)  # 5 and 4 nodes: past a tile edge
    P = v2.pack_padded(moved.values, tnb.bcs)
    cids, count = bd.compact_ids(tband.box_dilate(act, 1), act.numel())
    flags = bd.band_retube_plain(P, band, cids, 3, T.NarrowBandField.COMPUTE_HALO, tnb.shape,
                                 tiles, count)
    jmoved = jnb.with_values(jnp.asarray(_np(moved.values)), mask_update=False).update_band()
    np.testing.assert_array_equal(_np(band == 2), np.asarray(jmoved.mask))
    np.testing.assert_array_equal(_np(band != 0), np.asarray(jmoved.compute_mask))
    new_act = bd.scatter_activity(act, cids, flags)
    assert torch.equal(new_act, bd.tile_activity(band, tiles)) and not torch.equal(new_act, act)


# -- the stepper against JAX ---------------------------------------------------------


@pytest.fixture(scope="module")
def spiral():
    """Test2DBandPath's spiral: rotation + CurvatureTerm(-0.01), 3 RK3 steps,
    through JAX's band stepper (interpret mode) and general path."""
    jnb, tnb = _pair()
    jterms = (J.AdvectionTerm(_rot), J.CurvatureTerm(-0.01))
    dt = 0.2 * jnb.grid.min_spacing ** 2 / 0.02
    return (jnb, tnb, dt, _jax_band(jterms, jnb, J.RK3(), dt, 3),
            _jax_general(jterms, jnb, J.RK3(), dt, 3))


def test_spiral_matches_jax_band_stepper_and_general_path(spiral):
    jnb, tnb, dt, jband, jgeneral = spiral
    terms = (T.AdvectionTerm(_rot), T.CurvatureTerm(-0.01))
    stepper, state, got = _port_steps(terms, tnb, T.RK3(), dt, 3)
    assert stepper.tiles == tband.TILES_2D and stepper.incremental
    assert [spec.route for spec, _ in stepper.entries] == ["program", "const"]
    assert state.bufs[0].shape == v2.padded_shape(SHAPE)  # the 2D layout
    _close(got, jband)
    _close(got, jgeneral)


def test_cfl_over_the_2d_band_matches_jax(spiral):
    jnb, tnb, _, _, _ = spiral
    for jterms, terms in (((J.AdvectionTerm(_rot),), (T.AdvectionTerm(_rot),)),
                          ((J.CurvatureTerm(-0.01), J.NormalMotionTerm(0.2)),
                           (T.CurvatureTerm(-0.01), T.NormalMotionTerm(0.2)))):
        stepper = tband.FusedBandStepper(terms, tnb, T.RK3())
        dt, count = stepper.cfl(stepper.pack(tnb), 0.1)
        want = float(J.compute_cfl(jterms, jnb, 0.1))
        assert float(dt) == pytest.approx(want, rel=1e-14, abs=0)
        assert int(count) <= stepper.capacity


@pytest.mark.parametrize("integ", ["rk2", "fe"])
def test_streamed_velocity_matches_jax(integ):
    """Test2DBandPath's streamed velocity (RK2; and FE): two steps against
    JAX's general path with ``update_band``."""
    jint, tint = {"rk2": (J.RK2(), T.RK2()), "fe": (J.ForwardEuler(), T.ForwardEuler())}[integ]
    jnb, tnb = _pair()
    grid = jnb.grid
    jvel = J.sample(lambda X, Y: (-Y + 0.0 * X, X + 0.0 * Y), grid, J.Extrapolation(2),
                    vector=True)
    tvel = T.MeshField(torch.from_numpy(np.array(jvel.values)), tnb.grid)
    dt = 0.25 * grid.min_spacing
    _, _, got = _port_steps((T.AdvectionTerm(tvel),), tnb, tint, dt, 2)
    _close(got, _jax_general((J.AdvectionTerm(jvel),), jnb, jint, dt, 2))


def _rot_polar(xs, t):
    """:func:`_rot` in polar form: ``atan2`` does not trace, so the port
    evaluates it per stage at the dispatched nodes (the stream route)."""
    m = torch if isinstance(xs[0], torch.Tensor) else jnp
    r, th = m.hypot(xs[0], xs[1]), m.arctan2(xs[1], xs[0])
    return (-r * m.sin(th), r * m.cos(th))


def test_a_callable_on_the_stream_route_matches_jax():
    jnb, tnb = _pair(nlayers=3)
    dt = 0.25 * jnb.grid.min_spacing
    stepper, state, got = _port_steps((T.AdvectionTerm(_rot_polar),), tnb, T.RK3(), dt, 2)
    assert [spec.route for spec, _ in stepper.entries] == ["stream"] and state.xs is not None
    _close(got, _jax_general((J.AdvectionTerm(_rot_polar),), jnb, J.RK3(), dt, 2))


def test_integrate_takes_the_band_path_and_matches_jax():
    jnb, tnb = _pair()
    tf = 2.5 * 0.25 * jnb.grid.min_spacing
    jeq = J.LevelSetEquation(terms=J.AdvectionTerm(_rot), ic=jnb, integrator=J.RK3())
    jeq.integrate(tf, fast="interpret")
    assert jeq.last_fast_path == "band"
    teq = T.LevelSetEquation(terms=T.AdvectionTerm(_rot), ic=tnb, integrator=T.RK3())
    teq.integrate(tf)
    assert teq.last_fast_path == "band" and teq.t == jeq.t
    assert isinstance(teq.state, T.NarrowBandField)
    _close(teq.state, jeq.current_state)
    # hooks and fast="off" take the general path, which agrees
    off = T.LevelSetEquation(terms=T.AdvectionTerm(_rot), ic=tnb, integrator=T.RK3())
    off.integrate(tf, fast="off")
    assert off.last_fast_path is None
    _close(teq.state, off.state)


@pytest.mark.parametrize("bc", ["symmetry", "extrap1"])
def test_a_band_at_the_faces_turns_the_gates_on(bc):
    """A circle that crosses the faces x = -1 and y = 1: K7's gates are on
    and the stepper matches JAX's general path with ``update_band``."""
    jnb, tnb = _pair((40, 56), center=(-0.8, 0.7), radius=0.6, bc=bc, nlayers=3)
    jterms = (J.AdvectionTerm(_rot), J.NormalMotionTerm(0.2))
    terms = (T.AdvectionTerm(_rot), T.NormalMotionTerm(0.2))
    dt = 0.2 * jnb.grid.min_spacing
    stepper, state, got = _port_steps(terms, tnb, T.RK3(), dt, 3)
    assert state.flags.tolist() == [1, 1]
    _close(got, _jax_general(jterms, jnb, J.RK3(), dt, 3))
    assert not torch.equal(got.mask, tnb.mask)


def test_a_periodic_band_is_refused_by_both_packages():
    grid = ((-1.0, -1.0), (1.0, 1.0), (16, 16))
    v = np.random.default_rng(0).standard_normal((16, 16))
    with pytest.raises(ValueError, match="Periodic"):
        JNB(jnp.asarray(v), J.Grid(*grid), J.Periodic())
    with pytest.raises(ValueError, match="Periodic"):
        T.NarrowBandField(torch.from_numpy(v), T.Grid(*grid), T.Periodic())


def test_shallow_2d_tiles_take_the_full_retube_on_the_cpu_and_are_refused_on_cuda(monkeypatch):
    jnb, tnb = _pair(nlayers=3)
    dt = 0.25 * jnb.grid.min_spacing
    stepper, _, got = _port_steps((T.AdvectionTerm(_rot),), tnb, T.RK2(), dt, 2, tiles=(6, 32))
    assert not stepper.incremental
    _close(got, _jax_general((J.AdvectionTerm(_rot),), jnb, J.RK2(), dt, 2))
    monkeypatch.setattr(T.NarrowBandField, "device", property(lambda self: torch.device("cuda")))
    with pytest.raises(ValueError, match="reach 1 \\+ nlayers \\+ COMPUTE_HALO = 7"):
        tband.FusedBandStepper((T.AdvectionTerm(_rot),), tnb, T.RK2(), tiles=(6, 32))
    with pytest.raises(ValueError, match="2 positive sizes"):
        tband.FusedBandStepper((T.AdvectionTerm(_rot),), tnb, T.RK2(), tiles=(16, 16, 16))


def test_a_2d_band_routes_to_the_band_stepper_on_cuda():
    """A 2D band on CUDA takes the band stepper, under Extrapolation(8) too
    (the ghost kernels' table route): no item is pending, and the band
    stepper's steps equal JAX's general path with ``update_band``."""
    grid = T.Grid(LO, HI, (16, 16))
    tnb = T.NarrowBandField.from_field(T.sample(lambda X, Y: torch.sqrt(X ** 2 + Y ** 2) - 0.5,
                                                grid, T.Extrapolation(2), dtype=torch.float64,
                                                device="cpu"))
    term = T.AdvectionTerm(_rot)
    assert not hasattr(tfused, "PENDING") and not hasattr(tfused, "pending")
    assert tband.unsupported_reason((term,), tnb, T.RK3()) is None
    assert isinstance(T.LevelSetEquation(terms=term, ic=tnb)._cuda_stepper(False, "auto"),
                      tband.FusedBandStepper)
    jnb8, tnb8 = _pair((24, 32))
    jnb8, tnb8 = (jnb8.with_bcs(J.Extrapolation(8), replace=True),
                  tnb8.with_bcs(T.Extrapolation(8), replace=True))
    assert tband.unsupported_reason((term,), tnb8, T.RK3()) is None
    assert isinstance(T.LevelSetEquation(terms=term, ic=tnb8)._cuda_stepper(False, "auto"),
                      tband.FusedBandStepper)
    dt = 0.3 * tnb8.grid.min_spacing
    _, _, out = _port_steps((term,), tnb8, T.RK3(), dt, 2)
    _close(out, _jax_general((J.AdvectionTerm(_rot),), jnb8, J.RK3(), dt, 2))


def test_overflow_regrows_before_stepping():
    _, tnb = _pair(nlayers=3)
    tf = 3 * 0.25 * tnb.grid.min_spacing
    ref = T.LevelSetEquation(terms=T.AdvectionTerm(_rot), ic=tnb)
    ref.integrate(tf)
    init = tband.FusedBandStepper.__init__
    made = []

    def tiny(self, *a, capacity=None, **k):
        init(self, *a, capacity=capacity if made else 2, **k)
        made.append(self.capacity)

    tband.FusedBandStepper.__init__ = tiny
    try:
        eq = T.LevelSetEquation(terms=T.AdvectionTerm(_rot), ic=tnb)
        eq.integrate(tf)
    finally:
        tband.FusedBandStepper.__init__ = init
    assert made[0] == 2 and len(made) > 1 and eq.last_fast_path == "band"
    assert torch.equal(eq.state.values, ref.state.values)
    assert torch.equal(eq.state.mask, ref.state.mask)


# -- the eikonal smoothing spacing: the port does not copy JAX's embedding fault ------


def test_eikonal_smoothing_uses_the_fields_spacing():
    """A 2D band with spacing 2 under the recomputed-sign eikonal term. JAX's
    band embedding gives its dummy axis spacing 1.0 and smooths the sign
    with ``min(spacing)`` = 1 (``band_fused.py:148``, ``band_pallas.py:659``);
    JAX's general path, and the port, smooth with the field's 2. The port
    matches the general path to 1e-12 and differs from JAX's band stepper
    by 9.8e-2, 5.8e-4 of the field's max (ROADMAP.md queue 3)."""
    shape = (32, 128)  # JAX's band stepper takes n1 % 128 == 0
    lo, hi = (0.0, 0.0), (62.0, 254.0)  # h = 2
    jnb, tnb = _pair(shape, center=(30.0, 126.0), radius=20.0, nlayers=3, lo=lo, hi=hi)
    assert tnb.grid.spacing == (2.0, 2.0)
    # a field that is no signed distance (|grad| = 1.5), so the term acts
    jnb = JNB(1.5 * jnb.values, jnb.grid, jnb.bcs, jnb.mask, 3)
    tnb = T.NarrowBandField(1.5 * tnb.values, tnb.grid, tnb.bcs, tnb.mask, 3)
    dt = 0.3 * 2.0
    _, _, got = _port_steps((T.EikonalReinitializationTerm(),), tnb, T.RK3(), dt, 2)
    jterms = (J.EikonalReinitializationTerm(),)
    _close(got, _jax_general(jterms, jnb, J.RK3(), dt, 2))
    jband = _jax_band(jterms, jnb, J.RK3(), dt, 2)
    np.testing.assert_array_equal(_np(got.mask), np.asarray(jband.mask))
    fault = np.abs(_np(got.values) - np.asarray(jband.values)).max()
    assert 1e-4 < fault / np.abs(np.asarray(jband.values)).max() < 1e-3, fault
    # the dense 2D embedding keeps the field's spacing too
    dense = T.MeshField(tnb.values, tnb.grid, tnb.bcs)
    assert tfused.embed_2d(dense)[2] == (2.0, 2.0, 2.0)


# -- rollout and its gradient ----------------------------------------------------------


def test_rollout_gradient_matches_jax():
    """The 2D band rollout through the band stepper (``loop._band_rollout``,
    the card's route; here on the plain versions) and through the CPU's
    general path, values and the gradient of ``sum(phi^2)`` w.r.t. phi0
    and a streamed velocity, against ``jax.grad`` of JAX's rollout (its
    general band path), on tie-free data (the circle plus seeded noise)."""
    shape = (24, 40)
    jnb, tnb = _pair(shape, center=(0.1, -0.05), radius=0.55, nlayers=3)
    noise = 1e-6 * np.random.default_rng(4).standard_normal(shape)
    phi0 = np.asarray(jnb.values) + noise
    vel = np.stack(np.meshgrid(*[np.linspace(a, b, n) for a, b, n in zip(LO, HI, shape)],
                               indexing="ij"))[::-1] * np.array([-1.0, 1.0])[:, None, None]
    dt, nsteps = 0.2 * jnb.grid.min_spacing, 2

    def jloss(v, u):
        nb = JNB(v, jnb.grid, jnb.bcs, None, 3)
        term = J.AdvectionTerm(J.MeshField(u, jnb.grid))
        out, _ = J.rollout(J.RK3(), (term,), nb, 0.0, dt, nsteps, fast="off")
        return jnp.sum(out.values ** 2)

    jl, (jgv, jgu) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(phi0),
                                                              jnp.asarray(vel))
    for route in ("band", "general"):
        v = torch.from_numpy(phi0.copy()).requires_grad_()
        u = torch.from_numpy(vel.copy()).requires_grad_()
        nb = T.NarrowBandField(v, tnb.grid, tnb.bcs, None, 3)
        term = T.AdvectionTerm(T.MeshField(u, tnb.grid))
        run = tloop._band_rollout if route == "band" else T.rollout
        out, _ = run(T.RK3(), (term,), nb, 0.0, dt, nsteps)
        loss = (out.values ** 2).sum()
        gv, gu = torch.autograd.grad(loss, (v, u))
        assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-13)
        for a, b in ((gv, jgv), (gu, jgu)):
            b = np.asarray(b)
            assert float(np.abs(b).max()) > 0
            assert np.abs(_np(a) - b).max() <= 1e-10 * np.abs(b).max()


def test_rollout_under_remat_keeps_the_band_and_its_masks():
    """The band rollout in checkpointed chunks of 2 steps gives the CPU's
    general band path (held to JAX's above), values and masks."""
    _, tnb = _pair((32, 48), radius=0.55, nlayers=3)
    dt = 0.2 * tnb.grid.min_spacing
    ref, _ = T.rollout(T.RK3(), (T.AdvectionTerm(_rot),), tnb, 0.0, dt, 4)
    out, _ = tloop._band_rollout(T.RK3(), (T.AdvectionTerm(_rot),), tnb, 0.0, dt, 4,
                                 remat_chunk=2)
    assert isinstance(out, T.NarrowBandField) and torch.equal(out.mask, ref.mask)
    assert float((out.values - ref.values).abs().max()) <= TOL * float(ref.values.abs().max())


# -- the band field and its checkpoints ------------------------------------------------


def test_2d_band_masks_match_jax():
    jnb, tnb = _pair()
    np.testing.assert_array_equal(_np(tnb.mask), np.asarray(jnb.mask))
    np.testing.assert_array_equal(_np(tnb.compute_mask), np.asarray(jnb.compute_mask))
    _, moved = _pair(center=(0.07, 0.0))
    ju = jnb.with_values(jnp.asarray(_np(moved.values)), mask_update=False).update_band()
    tu = tnb.with_values(moved.values, mask_update=False).update_band()
    np.testing.assert_array_equal(_np(tu.mask), np.asarray(ju.mask))
    np.testing.assert_array_equal(_np(tu.compute_mask), np.asarray(ju.compute_mask))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_2d_band_checkpoint_across_packages(writer, tmp_path):
    jnb, tnb = _pair(bc="symmetry")
    src = jnb if writer == "jax" else tnb
    path = tmp_path / "band2d.npz"
    save, load = ((jck.save_checkpoint, lambda p: tck.load_checkpoint(p, device="cpu"))
                  if writer == "jax" else (tck.save_checkpoint, jck.load_checkpoint))
    save(path, src, t=0.5, metadata={"step": 7})
    phi, t, _, meta = load(path)
    assert type(phi).__name__ == "NarrowBandField" and phi.nlayers == 4 and phi.ndim == 2
    assert t == 0.5 and meta == {"step": 7}
    arr = lambda x: _np(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    np.testing.assert_array_equal(arr(phi.values), np.asarray(jnb.values))
    np.testing.assert_array_equal(arr(phi.mask), np.asarray(jnb.mask))
    np.testing.assert_array_equal(arr(phi.compute_mask), np.asarray(jnb.compute_mask))
    assert [type(b).__name__ for pair in phi.bcs for b in pair] == ["Symmetry"] * 4
