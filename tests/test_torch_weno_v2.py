"""Parity of the port's padded layout and its two kernel wrappers with the JAX
package, on the CPU in float64.

On a CPU tensor ``fused_stage`` (K1) and ``refresh_ghosts_fast`` (K2) run
their plain versions; JAX's Pallas kernels run in interpret mode. The two
packages store different padded layouts (the port keeps 3 ghosts on every
axis, JAX an 8-row pad on axis 1 and no lane ghosts), so full buffers are
compared only against ``pad_ghost`` and the JAX buffers through the parts
both hold: the interior and the axis-0/1 shells.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.models import shapes as jshapes
from lsm_tpu.ops import weno_v2 as jv2
from lsm_tpu_torch.core import bc as tbc
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.ops import weno_v2 as tv2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _cases(pkg):
    """The five BC cases of the JAX refresh parity test."""
    return [
        pkg.normalize_bcs(pkg.Periodic(), 3),
        pkg.normalize_bcs(pkg.Symmetry(), 3),
        pkg.normalize_bcs(pkg.Extrapolation(0), 3),
        pkg.normalize_bcs(pkg.Extrapolation(2), 3),
        pkg.normalize_bcs([(pkg.Symmetry(), pkg.Extrapolation(1)), pkg.Periodic(),
                           (pkg.Extrapolation(3), pkg.Symmetry())], 3),
    ]


CASE_IDS = ["periodic", "symmetry", "extrap0", "extrap2", "mixed"]


@pytest.mark.parametrize("case", range(5), ids=CASE_IDS)
def test_refresh_ghosts_matches_jax(case):
    tb, jb = _cases(T)[case], _cases(J)[case]
    shape = (12, 16, 128)
    n0, n1, n2 = shape
    rng = np.random.default_rng(case)
    vals = rng.standard_normal(shape)
    # port: scribble every shell of a packed buffer, then refresh in place
    P = tv2.pack_padded(torch.from_numpy(vals), tb)
    inner = torch.zeros_like(P, dtype=torch.bool)
    tv2.unpack_padded(inner, shape).fill_(True)
    P[~inner] = torch.from_numpy(rng.standard_normal(int((~inner).sum())))
    got = tv2.refresh_ghosts_fast(P, tb, shape)
    assert got is P
    assert tv2.refresh_ghosts_fast.launches == 0  # CPU tensors never launch
    # full padded buffer against pad_ghost of the interior
    ref_full = tbc.pad_ghost(torch.from_numpy(vals), tb, 3)
    np.testing.assert_allclose(_np(P), _np(ref_full), rtol=0, atol=1e-11)
    # interior + axis-0/1 shells against JAX's in-place Pallas refresh
    JP = jv2.pack_padded(jnp.asarray(vals), jb)
    JP = (JP.at[0:3].add(7.0).at[-3:].add(-3.0).at[:, 5:8].add(2.0).at[:, -8:-5].add(1.0))
    jref = np.asarray(jv2.refresh_ghosts_fast(JP, jb, shape, interpret=True))
    np.testing.assert_allclose(_np(P[:, :, 3:3 + n2]), jref[:, 5:11 + n1, :],
                               rtol=0, atol=1e-11)


def test_refresh_ghosts_functional_and_checks():
    bcs = _cases(T)[4]
    shape = (6, 7, 8)
    vals = torch.from_numpy(np.random.default_rng(1).standard_normal(shape))
    P = tv2.pack_padded(vals, bcs)
    P2 = P.clone()
    tv2.unpack_padded(P2, shape).mul_(2.0)
    R = tv2.refresh_ghosts(P2, bcs, shape)
    assert R is not P2
    np.testing.assert_allclose(_np(R), _np(2.0 * P), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="shape"):
        tv2.refresh_ghosts_fast(P[:-1].contiguous(), bcs, shape)
    with pytest.raises(ValueError, match="contiguous"):
        tv2.refresh_ghosts_fast(P.transpose(0, 1), bcs, (7, 6, 8))
    with pytest.raises(TypeError, match="dtype"):
        tv2.refresh_ghosts_fast(P.to(torch.float16), bcs, shape)
    with pytest.raises(ValueError, match=r"degree \+ 1 <= n"):  # 9 nodes for degree 8
        tv2.refresh_ghosts_fast(P, T.normalize_bcs(T.Extrapolation(8), 3), shape)
    small = torch.zeros(tv2.padded_shape((3, 5, 5)), dtype=torch.float64)
    with pytest.raises(ValueError, match="needs >= 4"):
        tv2.refresh_ghosts_fast(small, T.normalize_bcs(T.Periodic(), 3), (3, 5, 5))


def test_ghost_args_weights():
    """K2's host-side weight table: row for distance k is W[3-k] on both sides."""
    bcs = T.normalize_bcs([(T.Extrapolation(2), T.Extrapolation(7)), T.Periodic(),
                           (T.Symmetry(), T.Extrapolation(0))], 3)
    kinds, degrees, weights = tv2._ghost_args(bcs, (9, 9, 9))
    assert list(kinds) == [2, 2, 0, 0, 1, 2]
    assert list(degrees) == [2, 7, 0, 0, 0, 0]
    w = np.ctypeslib.as_array(weights).reshape(6, 3, 8)
    for a, P in ((0, 2), (1, 7), (5, 0)):
        W = tbc._lagrange_extrap_weights(3, P)
        for k in (1, 2, 3):
            np.testing.assert_array_equal(w[a, k - 1, :P + 1], W[3 - k])
            assert not w[a, k - 1, P + 1:].any()
    assert isinstance(kinds, ctypes.Array)


def _velf(xs, t):
    # u1 crosses exactly 0 on the plane x = 0.5 (tie cells); works for jnp and torch
    return (
        0.5 - xs[1] + 0.0 * (xs[0] + xs[2]),
        xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
        0.1 + 0.3 * t + 0.0 * (xs[0] + xs[1] + xs[2]),
    )


SHAPE = (16, 16, 128)


@pytest.mark.parametrize("velocity", ["stream", "callable"])
@pytest.mark.parametrize("with_aux", [False, True], ids=["noaux", "aux"])
def test_stage_matches_jax(velocity, with_aux):
    rng = np.random.default_rng(3)
    args = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), SHAPE)
    jg, tg = J.Grid(*args), T.Grid(*args)
    jphi = J.sample(jshapes.zalesak_sphere(), jg, J.Periodic(), dtype=jnp.float64)
    tphi = T.sample(tshapes.zalesak_sphere(), tg, T.Periodic(), dtype=torch.float64,
                    device="cpu")
    vel = rng.standard_normal((3, *SHAPE))
    vel[0, :, :, ::4] = 0.0  # tie cells
    aux = rng.standard_normal(SHAPE) if with_aux else None
    coeffs, t = (0.75, 0.25, 0.25 * 2e-3), 0.3
    if velocity == "stream":
        jspec = ((jv2.TermSpec("advection", "stream", None, 3),
                  tuple(jnp.asarray(vel[d]) for d in range(3))),)
        tu = tuple(torch.from_numpy(vel[d]).contiguous() for d in range(3))
        tspec = ((tv2.TermSpec("advection", "stream", None, 3), tu),)
    else:
        jspec = ((jv2.TermSpec("advection", "analytic", _velf, 0), ()),)
        tspec = ((tv2.TermSpec("advection", "analytic", _velf, 0), ()),)
        xs = tv2.node_coords(SHAPE, tg.spacing, tg.lo, torch.float64)
        tu = tv2.eval_components(_velf(xs, t), SHAPE, torch.float64, "cpu")
    JP = jv2.pack_padded(jphi.values, jphi.bcs)
    JA = None if aux is None else jv2.pack_padded(jnp.asarray(aux), jphi.bcs)
    TP = tv2.pack_padded(tphi.values, tphi.bcs)
    TA = None if aux is None else tv2.pack_padded(torch.from_numpy(aux), tphi.bcs)
    jout = jv2.unpack_padded(jv2.fused_stage(
        JP, jspec, coeffs, t, JA, jphi.bcs, jg.spacing, SHAPE, jg.lo, interpret=True), SHAPE)
    jref = jv2.stage_reference(JP, jspec, coeffs, t, JA, jphi.bcs, jg.spacing, SHAPE, jg.lo)
    out = tv2.fused_stage(TP, tu, coeffs, TA, tg.spacing, SHAPE)
    assert tv2.fused_stage.launches == 0
    got = _np(tv2.unpack_padded(out, SHAPE))
    np.testing.assert_allclose(got, np.asarray(jout), rtol=0, atol=1e-11)
    np.testing.assert_allclose(got, np.asarray(jref), rtol=0, atol=1e-11)
    tref = tv2.stage_reference(TP, tspec, coeffs, t, TA, tphi.bcs, tg.spacing, SHAPE, tg.lo)
    np.testing.assert_allclose(_np(tref), np.asarray(jref), rtol=0, atol=1e-11)


def test_stage_plain_float32_matches_float64():
    """The plain stage in the card's working dtype stays within f32 round-off
    of the f64 one (the scale the on-card kernel check uses)."""
    args = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (12, 10, 14))
    g = T.Grid(*args)
    phi = T.sample(tshapes.zalesak_sphere(), g, T.Periodic(), dtype=torch.float64,
                   device="cpu")
    xs = tv2.node_coords(g.shape, g.spacing, g.lo, torch.float64)
    u = tv2.eval_components(_velf(xs, 0.0), g.shape, torch.float64, "cpu")
    P = tv2.pack_padded(phi.values, phi.bcs)
    ref = tv2.stage_plain(P, u, (0.0, 1.0, 1e-2), None, g.spacing, g.shape)
    got = tv2.stage_plain(P.float(), tuple(c.float() for c in u), (0.0, 1.0, 1e-2), None,
                          g.spacing, g.shape)
    d = (tv2.unpack_padded(got, g.shape).double() - tv2.unpack_padded(ref, g.shape)).abs()
    assert float(d.max()) <= 1e-5 * max(float(tv2.unpack_padded(ref, g.shape).abs().max()), 1.0)


def test_fused_stage_checks():
    shape = (5, 6, 7)
    P = torch.zeros(tv2.padded_shape(shape), dtype=torch.float64)
    u = tuple(torch.zeros(shape, dtype=torch.float64) for _ in range(3))
    sp = (0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="needs 3 components"):
        tv2.fused_stage(P, u[:2], (0, 1, 1), None, sp, shape)
    with pytest.raises(ValueError, match="expected"):
        tv2.fused_stage(P, u, (0, 1, 1), None, sp, (5, 6, 8))
    with pytest.raises(ValueError, match="but the state is"):
        tv2.fused_stage(P, (u[0].float(), u[1], u[2]), (0, 1, 1), None, sp, shape)
    with pytest.raises(ValueError, match="contiguous"):
        tv2.fused_stage(P, (u[0], u[1], u[2].transpose(0, 1).contiguous().transpose(0, 1)),
                        (0, 1, 1), None, sp, shape)
    with pytest.raises(ValueError, match="aux"):
        tv2.fused_stage(P, u, (0, 1, 1), P[1:], sp, shape)
    with pytest.raises(TypeError, match="dtype"):
        tv2.fused_stage(P.to(torch.int32), u, (0, 1, 1), None, sp, shape)
    with pytest.raises(ValueError, match="unknown term kind"):
        tv2.stage_reference(P, ((tv2.TermSpec("bogus", "stream", None, 1), (u[0],)),),
                            (0, 1, 1), 0.0, None, T.normalize_bcs(T.Periodic(), 3), sp,
                            shape, (0.0, 0.0, 0.0))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "CUDA_DEFAULT", str(tmp_path / "default"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    with pytest.raises(RuntimeError, match="cannot run"):
        _build.compile_library(tmp_path / "lib.so", str(tmp_path / "no-nvcc"))


def test_build_failure_carries_compiler_output(tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'weno_stage.cu(12): error: something broke' >&2\nexit 2\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="something broke") as info:
        _build.compile_library(tmp_path / "out" / "lib.so", str(fake))
    assert "exit code 2" in str(info.value) and "sm_90a" in str(info.value)
    assert not list((tmp_path / "out").iterdir())  # no half-written library left
