"""Parity of the port's stage backward with the JAX package, on the CPU in
float64: the hand WENO5 adjoint, the ghost-cotangent fold (K4's plain
version), the shell zeroing (K5's) and the stage backward (K3's), against
``lsm_tpu.ops.stencils.weno5_upwind_fwd_bwd``, ``lsm_tpu.ops.weno_v2_bwd``
and the port's own autograd oracle.

The two packages store different padded layouts (the port keeps 3 ghosts on
every axis, JAX an 8-row pad on axis 1 and no lane ghosts), so cotangents are
compared on the interior after each package's own fold, never as raw padded
buffers. A cotangent handed to both packages carries nothing on the port's
axis-2 ghosts, which JAX does not store.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.ops import stencils as jst
from lsm_tpu.ops import weno_v2 as jv2
from lsm_tpu.ops import weno_v2_bwd as jbwd
from lsm_tpu_torch.ops import stencils as tst
from lsm_tpu_torch.ops import weno_v2 as tv2
from lsm_tpu_torch.ops import weno_v2_bwd as tbwd


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


def _cases(pkg):
    """The five BC cases of the refresh parity tests."""
    return [
        pkg.normalize_bcs(pkg.Periodic(), 3),
        pkg.normalize_bcs(pkg.Symmetry(), 3),
        pkg.normalize_bcs(pkg.Extrapolation(0), 3),
        pkg.normalize_bcs(pkg.Extrapolation(2), 3),
        pkg.normalize_bcs([(pkg.Symmetry(), pkg.Extrapolation(1)), pkg.Periodic(),
                           (pkg.Extrapolation(3), pkg.Symmetry())], 3),
    ]


CASE_IDS = ["periodic", "symmetry", "extrap0", "extrap2", "mixed"]


def _diffs(rng, n):
    """Six backward differences with flat stencils (all v_i^2 tie), uniform
    slopes, odd-symmetric stencils (|v1| = |v5|, |v2| = |v4|) and jumps."""
    dm = rng.standard_normal((6, n))
    dm[:, : n // 8] = 0.0
    dm[:, n // 8: n // 4] = 1.5
    a, b = rng.standard_normal((2, n // 8))
    dm[:, n // 4: 3 * n // 8] = np.stack([a, b, a, 0 * a, -a, -b])
    dm[:, 3 * n // 8: 3 * n // 8 + 8] *= 1e3
    return dm


def test_weno5_upwind_fwd_bwd_matches_jax_with_ties():
    rng = np.random.default_rng(31)
    n = 512
    dm = _diffs(rng, n)
    u = rng.standard_normal(n)
    u[::5] = 0.0  # u == 0 takes the plus branch
    u[1::7] = -0.0
    g = rng.standard_normal(n)
    H, ddm, du = tst.weno5_upwind_fwd_bwd([torch.from_numpy(d) for d in dm],
                                          torch.from_numpy(u), torch.from_numpy(g))
    jH, jddm, jdu = jst.weno5_upwind_fwd_bwd([jnp.asarray(d) for d in dm], jnp.asarray(u),
                                             jnp.asarray(g))
    np.testing.assert_allclose(_np(H), np.asarray(jH), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(du), np.asarray(jdu), rtol=0, atol=1e-12)
    for a, b in zip(ddm, jddm):
        scale = max(np.abs(np.asarray(b)).max(), 1.0)
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-12 * scale)
    # the forward value is weno5_upwind's, and the adjoint is its autograd in f64
    dmt = [torch.from_numpy(d).requires_grad_() for d in dm]
    ref = tst.weno5_upwind(dmt, torch.from_numpy(u))
    np.testing.assert_array_equal(_np(H), _np(ref))
    ad = torch.autograd.grad(ref, dmt, grad_outputs=torch.from_numpy(g))
    for a, b in zip(ddm, ad):
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= 1e-10 * scale


def test_hand_adjoint_float32_right_at_tie_cells():
    """At a WENO-symmetric cell the float32 autograd of the forward is wrong
    by O(1) and the hand association is not (the JAX package's pinned case,
    ``tests/test_fused_bwd.py``)."""
    dmv = [0.00313568115234375, 0.003143310546875, 0.00313568115234375, 0.0,
           -0.00313568115234375, -0.003143310546875]

    def run(dtype):
        dm = [torch.tensor([v], dtype=dtype, requires_grad=True) for v in dmv]
        u = torch.tensor([-0.5], dtype=dtype)
        g = torch.tensor([1.2142245769500732], dtype=dtype)
        ad = torch.autograd.grad(tst.weno5_upwind(dm, u), dm, grad_outputs=g)
        _, hand, _ = tst.weno5_upwind_fwd_bwd([d.detach() for d in dm], u, g)
        return (np.array([float(d) for d in ad]), np.array([float(d) for d in hand]))

    ad64, hand64 = run(torch.float64)
    np.testing.assert_allclose(hand64, ad64, rtol=1e-10, atol=1e-14)
    ad32, hand32 = run(torch.float32)
    scale = np.abs(ad64).max()
    assert np.abs(hand32 - ad64).max() < 1e-2 * scale
    assert np.abs(ad32 - ad64).max() > scale


FOLD_SHAPE = (10, 12, 14)


@pytest.mark.parametrize("case", range(5), ids=CASE_IDS)
def test_fold_matches_jax_and_autograd(case):
    tb, jb = _cases(T)[case], _cases(J)[case]
    n0, n1, n2 = FOLD_SHAPE
    rng = np.random.default_rng(40 + case)
    # every shell of the port's layout: the plain fold against the autograd
    # transpose of pack_padded, and the shells left zero
    G = torch.from_numpy(rng.standard_normal(tv2.padded_shape(FOLD_SHAPE)))
    ref = tbwd.fold_ghost_cotangent(G, tb, FOLD_SHAPE)
    got = tbwd.fold_ghost_cotangent_fast(G.clone(), tb, FOLD_SHAPE)
    assert tbwd.fold_ghost_cotangent_fast.launches == 0  # CPU tensors never launch
    scale = float(ref.abs().max())
    assert float((tv2.unpack_padded(got, FOLD_SHAPE) - ref).abs().max()) <= 1e-12 * scale
    inner = torch.zeros_like(got, dtype=torch.bool)
    tv2.unpack_padded(inner, FOLD_SHAPE).fill_(True)
    assert not got[~inner].any()
    # the shells both layouts store (axis 0 and 1): against JAX's fold
    G[:, :, :3] = 0.0
    G[:, :, 3 + n2:] = 0.0
    JG = jnp.zeros((n0 + 6, n1 + 16, n2)).at[:, 5:11 + n1, :].set(jnp.asarray(_np(G[:, :, 3:3 + n2])))
    jref = np.asarray(jbwd.fold_ghost_cotangent(JG, jb, FOLD_SHAPE))
    got = tv2.unpack_padded(tbwd.fold_ghost_cotangent_plain(G, tb, FOLD_SHAPE), FOLD_SHAPE)
    np.testing.assert_allclose(_np(got), jref, rtol=0, atol=1e-12 * np.abs(jref).max())


def test_zero_pad_shells_and_checks():
    shape = (5, 6, 7)
    buf = torch.randn(tv2.padded_shape(shape), dtype=torch.float64)
    inner = tv2.unpack_padded(buf, shape).clone()
    out = tbwd.zero_pad_shells(buf, shape)
    assert out is buf and tbwd.zero_pad_shells.launches == 0
    assert torch.equal(tv2.unpack_padded(buf, shape), inner)
    mask = torch.zeros_like(buf, dtype=torch.bool)
    tv2.unpack_padded(mask, shape).fill_(True)
    assert not buf[~mask].any()
    with pytest.raises(ValueError, match="expected"):
        tbwd.zero_pad_shells(buf[1:].contiguous(), shape)
    # a 2D shape is the 2D entry's (a 2D field's buffer): this 3D buffer's shape does not fit it
    with pytest.raises(ValueError, match="expected"):
        tbwd.fold_ghost_cotangent_fast(buf, T.normalize_bcs(T.Periodic(), 3), shape[:2])
    with pytest.raises(ValueError, match="3D or 2D"):
        tbwd.fold_ghost_cotangent_fast(buf, T.normalize_bcs(T.Periodic(), 3), shape[:1])
    u = tuple(torch.zeros(shape, dtype=torch.float64) for _ in range(3))
    with pytest.raises(ValueError, match="but the state is"):
        tbwd.stage_backward(buf, u, (0, 1, 1), None, buf.float(), (0.1,) * 3, shape)
    with pytest.raises(ValueError, match="one velocity component per axis"):
        tbwd.stage_backward(buf, u[:2], (0, 1, 1), None, buf, (0.1,) * 3, shape)


def _velf(xs, t):
    # u0 changes sign across the domain, u1 crosses 0 exactly at x = 0.5 (tie
    # cells), u2 depends on t; the same code runs on jnp arrays and tensors
    return (
        jnp.sin(xs[1]) + 0.1 * t + 0.0 * (xs[0] + xs[2]) if isinstance(xs[0], jnp.ndarray)
        else torch.sin(xs[1]) + 0.1 * t + 0.0 * (xs[0] + xs[2]),
        xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
        0.2 + 0.3 * t + 0.0 * (xs[0] + xs[1] + xs[2]),
    )


SHAPE = (16, 32, 128)
SPACING = (0.07, 0.05, 0.06)
LO = (0.0, -1.0, 0.5)
BCS = {"periodic": "Periodic", "symmetry": "Symmetry", "extrap1": "LinearExtrapolation"}


def _stage_inputs(bc, velocity, with_aux, seed):
    """The same stage inputs for both packages: ``(jax_args, port_args)``."""
    rng = np.random.default_rng(seed)
    jb = J.normalize_bcs(getattr(J, BCS[bc])(), 3)
    tb = T.normalize_bcs(getattr(T, BCS[bc])(), 3)
    n0, n1, n2 = SHAPE
    vals = rng.standard_normal(SHAPE)
    aux = rng.standard_normal(SHAPE) if with_aux else None
    g = rng.standard_normal(tv2.padded_shape(SHAPE))
    g[:, :, :3] = 0.0  # no cotangent on the port-only lane ghosts
    g[:, :, 3 + n2:] = 0.0
    coeffs, t = (0.3, 0.7, 0.12), 0.37
    JP = jv2.pack_padded(jnp.asarray(vals), jb)
    JA = None if aux is None else jv2.pack_padded(jnp.asarray(aux), jb)
    JG = jnp.zeros((n0 + 6, n1 + 16, n2)).at[:, 5:11 + n1, :].set(jnp.asarray(g[:, :, 3:3 + n2]))
    TP = tv2.pack_padded(torch.from_numpy(vals), tb)
    TA = None if aux is None else tv2.pack_padded(torch.from_numpy(aux), tb)
    if velocity == "stream":
        vel = 0.3 * rng.standard_normal((3, *SHAPE))
        vel[1, :, ::4] = 0.0  # tie cells
        jspec = (jv2.TermSpec("advection", "stream", None, 3),)
        jstreams = tuple(jnp.asarray(v) for v in vel)
        tu = tuple(torch.from_numpy(v).contiguous() for v in vel)
    else:
        jspec = (jv2.TermSpec("advection", "analytic", _velf, 0),)
        jstreams = ()
        tu = None
    j = (JP, jstreams, tuple(jnp.asarray(c) for c in coeffs), jnp.asarray(t), JA, JG,
         jspec, (len(jstreams),), jb, SPACING, SHAPE, LO)
    return j, (TP, tu, coeffs, t, TA, torch.from_numpy(g), tb)


def _port_backward(TP, tu, coeffs, t, TA, G, tb, backward):
    """The port's stage cotangents with ``backward`` (K3's plain version or
    the autograd oracle); the streams of a callable velocity are evaluated at
    ``t`` as the stepper does, and their cotangents pulled back to ``dt``."""
    tt = torch.tensor(t, dtype=torch.float64, requires_grad=True)
    if tu is None:
        xs = tv2.node_coords(SHAPE, SPACING, LO, torch.float64, "cpu")
        tu = tv2.eval_components(_velf(xs, tt), SHAPE, torch.float64, "cpu")
    u = tuple(c.detach() for c in tu)
    if backward == "plain":
        gf = tbwd.fold_ghost_cotangent_plain(G.clone(), tb, SHAPE)
        dP, du, dcoef, daux = tbwd.stage_backward(TP, u, coeffs, TA, gf, SPACING, SHAPE)
    else:
        dP, du, dcoef, daux = tbwd.composite_backward_autograd(TP, u, coeffs, TA, G, tb,
                                                               SPACING, SHAPE)
    dt = None
    if tu[0].requires_grad:
        dt = sum(float(torch.autograd.grad(c, tt, d, retain_graph=True)[0])
                 for c, d in zip(tu, du) if c.requires_grad)
    return dP, du, dcoef, daux, dt


@pytest.mark.parametrize("with_aux", [False, True], ids=["noaux", "aux"])
@pytest.mark.parametrize("velocity", ["stream", "callable"])
@pytest.mark.parametrize("bc", ["periodic", "symmetry", "extrap1"])
def test_stage_backward_matches_jax(bc, velocity, with_aux):
    jargs, (TP, tu, coeffs, t, TA, G, tb) = _stage_inputs(bc, velocity, with_aux,
                                                           seed=len(bc) + 7 * with_aux)
    jdP, jds, jdc, jdt, jda = jbwd._jnp_stage_backward(*jargs)
    dP, du, dcoef, daux, dt = _port_backward(TP, tu, coeffs, t, TA, G, tb, "plain")
    assert tbwd.stage_backward.launches == 0
    jb = jargs[8]
    jint = np.asarray(jbwd.fold_ghost_cotangent(jdP, jb, SHAPE))
    tint = tbwd.fold_ghost_cotangent(dP, tb, SHAPE)
    assert _rel(tint, jint) < 1e-9
    assert _rel(dcoef, np.array([float(c) for c in jdc])) < 1e-9
    if velocity == "stream":
        for a, b in zip(du, jds):
            assert _rel(a, b) < 1e-9
    else:
        assert abs(dt - float(jdt)) <= 1e-9 * max(abs(float(jdt)), 1.0)
    if with_aux:
        assert _rel(tv2.unpack_padded(daux, SHAPE), jv2.unpack_padded(jda, SHAPE)) < 1e-9
        inner = torch.zeros_like(daux, dtype=torch.bool)
        tv2.unpack_padded(inner, SHAPE).fill_(True)
        assert not daux[~inner].any()
    else:
        assert daux is None and float(dcoef[0]) == 0.0


@pytest.mark.parametrize("bc", ["periodic", "symmetry", "extrap1"])
def test_stage_backward_matches_autograd_oracle(bc):
    """K3's plain version against torch.autograd of stage + refresh, raw dP
    included (tie-free BCs), with aux and a streamed velocity."""
    _, (TP, tu, coeffs, t, TA, G, tb) = _stage_inputs(bc, "stream", True, seed=3)
    G = torch.from_numpy(np.random.default_rng(4).standard_normal(G.shape))  # all shells
    got = _port_backward(TP, tu, coeffs, t, TA, G, tb, "plain")
    ref = _port_backward(TP, tu, coeffs, t, TA, G, tb, "oracle")
    assert _rel(got[0], ref[0]) < 1e-12
    for a, b in zip(got[1], ref[1]):
        assert _rel(a, b) < 1e-12
    assert _rel(got[2], ref[2]) < 1e-12
    assert _rel(got[3], ref[3]) < 1e-12
    # the stage reads stored ghosts: dP lives on face ghosts, not on corners
    n0 = SHAPE[0]
    assert float(got[0][0, 3:-3, 3:-3].abs().max()) > 0.0
    assert float(got[0][0:3, 0:3, :].abs().max()) == 0.0
    assert float(got[0][n0 + 3:, :, 0:3].abs().max()) == 0.0


def test_fused_step_stage_backward_leaves_cotangent_alone():
    """The backward folds a copy of its cotangent: the caller's
    ``grad_outputs`` stay as given, and in ``y + w`` (whose AddBackward hands
    one buffer to both branches) ``w`` gets the cotangent unfolded."""
    shape, sp = (8, 10, 12), (0.1, 0.12, 0.09)
    rng = np.random.default_rng(61)
    bcs = T.normalize_bcs(T.Periodic(), 3)
    P = tv2.pack_padded(torch.from_numpy(rng.standard_normal(shape)), bcs).requires_grad_()
    u = tuple(torch.from_numpy(0.3 * rng.standard_normal(shape)) for _ in range(3))
    coeffs = (0.0, 1.0, 0.05)
    G = torch.from_numpy(rng.standard_normal(tv2.padded_shape(shape)))
    G0 = G.clone()
    ref = tbwd.composite_backward_autograd(P, u, coeffs, None, G0, bcs, sp, shape)[0]
    out = tv2.fused_step_stage(P, u, coeffs, None, bcs, sp, shape)
    (dP,) = torch.autograd.grad(out, P, grad_outputs=G)
    assert torch.equal(G, G0)
    assert _rel(dP, ref) < 1e-12
    w = torch.from_numpy(rng.standard_normal(G.shape)).requires_grad_()
    y = tv2.fused_step_stage(P, u, coeffs, None, bcs, sp, shape)
    dP, dw = torch.autograd.grad(y + w, (P, w), grad_outputs=G)
    assert torch.equal(G, G0) and torch.equal(dw, G0)
    assert _rel(dP, ref) < 1e-12


def test_stage_backward_matches_jax_pallas_kernel():
    """One case against the JAX Pallas backward itself (interpret mode)."""
    jargs, (TP, tu, coeffs, t, TA, G, tb) = _stage_inputs("periodic", "stream", True, seed=9)
    jdP, jds, jdc, _, jda = jbwd.stage_backward(*jargs, interpret=True)
    dP, du, dcoef, daux, _ = _port_backward(TP, tu, coeffs, t, TA, G, tb, "plain")
    jint = np.asarray(jbwd.fold_ghost_cotangent(jdP, jargs[8], SHAPE))
    assert _rel(tbwd.fold_ghost_cotangent(dP, tb, SHAPE), jint) < 1e-9
    for a, b in zip(du, jds):
        assert _rel(a, b) < 1e-9
    assert _rel(dcoef, np.array([float(c) for c in jdc])) < 1e-9
    assert _rel(tv2.unpack_padded(daux, SHAPE), jv2.unpack_padded(jda, SHAPE)) < 1e-9


def test_extrapolation2_composite_gradient_matches_jax():
    """Degree-2 extrapolation makes exact subgradient ties at boundary rows;
    the gradient w.r.t. the interior values still matches, here of two RK3
    steps through the port's fused stepper against JAX's general path."""
    shape = (12, 16, 20)
    rng = np.random.default_rng(17)
    args = ((0.0, 0.0, 0.0), (1.0, 2.0, 4.0), shape)
    x = np.linspace(0, 1, shape[0])[:, None, None]
    y = np.linspace(0, 1, shape[1])[None, :, None]
    z = np.linspace(0, 1, shape[2])[None, None, :]
    vals = (np.sqrt((x - 0.5) ** 2 + (y - 0.4) ** 2 + (z - 0.6) ** 2) - 0.3
            + 1e-3 * rng.standard_normal(shape))
    vel = 0.5 * rng.standard_normal((3, *shape))
    jg, tg = J.Grid(*args), T.Grid(*args)
    jphi = J.MeshField(jnp.asarray(vals), jg, J.Extrapolation(2))
    tphi = T.MeshField(torch.from_numpy(vals), tg, T.Extrapolation(2))
    dt = 0.2 * jg.min_spacing
    jterm = J.AdvectionTerm(J.MeshField(jnp.asarray(vel), jg))
    tterm = T.AdvectionTerm(T.MeshField(torch.from_numpy(vel), tg))

    def jloss(v):
        out, _ = J.rollout(J.RK3(), (jterm,), jphi.with_values(v), 0.0, dt, 2, fast="off")
        return jnp.sum(out.values ** 2)

    jgrad = np.asarray(jax.grad(jloss)(jphi.values))
    v = torch.from_numpy(vals).requires_grad_()
    out, _ = T.rollout(T.RK3(), (tterm,), tphi.with_values(v), 0.0, dt, 2)
    (tgrad,) = torch.autograd.grad((out.values ** 2).sum(), v)
    assert _rel(tgrad, jgrad) < 1e-10
