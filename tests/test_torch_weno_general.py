"""Parity of the general path's WENO5 stage (K10 3D, K11 2D) with the JAX
package, on the CPU.

On a CPU tensor ``weno_stage_general`` runs its plain version; JAX's Pallas
kernel ``weno_stage_pallas`` runs in interpret mode (float32, against which
the tolerance is ``tests/test_pallas.py``'s 1e-5) and its jnp reference
(float64, 1e-12). The differentiable entries are held against ``jax.grad``
of JAX's custom-VJP entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.models import shapes as jshapes
from lsm_tpu.ops import weno_pallas as jwp
from lsm_tpu_torch.ops import weno_general as twg
from lsm_tpu_torch.ops import weno_v2 as tv2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _vel(dims):
    # u1 crosses 0 on x = 0.5 (tie cells); the same code runs on jnp and torch
    if dims == 3:
        return lambda X, Y, Z: (0.5 - Y + 0 * (X + Z), X - 0.5 + 0 * (Y + Z),
                                0.1 + 0 * (X + Y + Z))
    return lambda X, Y: (0.5 - Y + 0 * X, X - 0.5 + 0 * Y)


def _close(got, want, tol):
    """``max|got - want| <= tol * max(max|want|, 1)``."""
    want = np.asarray(want)
    err = float(np.abs(_np(got) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


def _inputs(shape, jdtype, tdtype, bc="periodic", seed=0):
    """The same padded field, velocity and aux for both packages, made in
    float64 with numpy and cast once: a Zalesak field (3D sphere or 2D disk)
    with noise, the rotation velocity."""
    dims = len(shape)
    grid = J.Grid((0.0,) * dims, (1.0,) * dims, shape)
    shp = jshapes.zalesak_sphere() if dims == 3 else jshapes.zalesak_disk()
    rng = np.random.default_rng(seed)
    phi = np.asarray(J.sample(shp, grid, dtype=jnp.float64).values)
    phi = phi + 1e-3 * rng.standard_normal(shape)
    vel = np.array(J.sample(_vel(dims), grid, vector=True, dtype=jnp.float64).values)
    aux = rng.standard_normal(shape)
    jb = {"periodic": J.Periodic(), "extrap2": J.Extrapolation(2), "symmetry": J.Symmetry()}[bc]
    tb = {"periodic": T.Periodic(), "extrap2": T.Extrapolation(2), "symmetry": T.Symmetry()}[bc]
    tgrid = T.Grid((0.0,) * dims, (1.0,) * dims, shape)
    jp = J.MeshField(jnp.asarray(phi, jdtype), grid, jb).pad(3)
    tp = T.MeshField(torch.from_numpy(phi).to(tdtype), tgrid, tb).pad(3)
    return (grid, jp, tuple(jnp.asarray(vel[d], jdtype) for d in range(dims)),
            jnp.asarray(aux, jdtype), tp,
            tuple(torch.from_numpy(vel[d]).to(tdtype).contiguous() for d in range(dims)),
            torch.from_numpy(aux).to(tdtype))


PALLAS_CASES = {"3d_32": ((32, 32, 32), None), "3d_multi_tile": ((8, 8, 256), (8, 8, 128)),
                "2d_64": ((64, 64), None)}


@pytest.mark.parametrize("with_aux", [False, True], ids=["noaux", "aux"])
@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_matches_jax_pallas_interpret(case, with_aux):
    """float32: the port's plain K10/K11 against JAX's Pallas kernel in
    interpret mode, the bare Hamiltonian and a stage with or without aux."""
    shape, tiles = PALLAS_CASES[case]
    jg, jp, ju, jaux, tp, tu, taux = _inputs(shape, jnp.float32, torch.float32)
    sp = jg.spacing
    ham = jwp.weno_hamiltonian_pallas(jp, ju, sp, shape, interpret=True, tiles=tiles)
    got = twg.weno_hamiltonian(tp, tu, sp, shape)
    assert int(jnp.isnan(ham).sum()) == 0 and bool(torch.isfinite(got).all())
    assert float(np.abs(_np(got) - np.asarray(ham)).max()) < 1e-5
    coeffs = (0.75, 0.25, 2.5e-3)
    ref = jwp.weno_stage_pallas(jp, ju, sp, shape, coeffs=coeffs,
                                aux=jaux if with_aux else None, interpret=True, tiles=tiles)
    out = twg.weno_stage_general(tp, tu, sp, shape, coeffs, taux if with_aux else None)
    assert float(np.abs(_np(out) - np.asarray(ref)).max()) < 1e-5
    assert twg.weno_stage_3d.launches == twg.weno_stage_2d.launches == 0  # CPU: no launch


F64_CASES = {"3d_odd": ((13, 17, 19), "extrap2"), "3d_periodic": ((12, 16, 20), "periodic"),
             "2d_odd": ((23, 29), "symmetry"), "2d_periodic": ((32, 32), "periodic"),
             # K10's march on the card: axis 0 past one chunk of 64 planes, and
             # columns that tile neither axis 1 (16) nor axis 2 (32)
             "3d_past_chunk": ((67, 20, 33), "symmetry"), "3d_ragged": ((9, 37, 40), "periodic")}


@pytest.mark.parametrize("with_aux", [False, True], ids=["noaux", "aux"])
@pytest.mark.parametrize("case", list(F64_CASES))
def test_plain_matches_jax_jnp_f64(case, with_aux):
    """float64: the port's plain K10/K11 against JAX's jnp reference, on
    shapes no Pallas tile divides."""
    shape, bc = F64_CASES[case]
    jg, jp, ju, jaux, tp, tu, taux = _inputs(shape, jnp.float64, torch.float64, bc, seed=3)
    sp = jg.spacing
    ham = np.asarray(jwp._weno_hamiltonian_jnp(jp, ju, sp, shape))
    np.testing.assert_allclose(_np(twg.weno_hamiltonian(tp, tu, sp, shape)), ham, rtol=0,
                               atol=1e-12)
    coeffs = (1.0 / 3.0, 2.0 / 3.0, 1.7e-3)
    ref = np.asarray(jwp._stage_jnp(jp, ju, jaux if with_aux else None, coeffs, sp, shape))
    out = twg.weno_stage_general(tp, tu, sp, shape, coeffs, taux if with_aux else None)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-12)


#: K11's march on the card: axis 0 under one step of 8 rows and past one chunk
#: of 64 rows, axis 1 a multiple of neither 4 (16-byte copies) nor 128 (a
#: block's columns)
K11_MARCH_SHAPES = [(5, 131), (67, 37), (70, 9), (3, 258)]


@pytest.mark.parametrize("coeffs", [None, (0.0, 1.0, 1.7e-3), (0.75, 0.25, 2.5e-4)],
                         ids=["H", "stage", "stage_aux"])
@pytest.mark.parametrize("shape", K11_MARCH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k11_plain_equals_k1_2d_interior(shape, coeffs):
    """float64: K11's plain version equals, bit for bit, the interior of K1
    2D's plain streamed stage (``weno_v2.fused_stage`` on the ``(n0+6,
    n1+6)`` buffer, aux placed in its padded layout), the function K11's march
    and K1 2D's march share on the card."""
    rng = np.random.default_rng(sum(shape))
    bcs = T.normalize_bcs(T.Periodic() if min(shape) >= 4 else T.Extrapolation(2), 2)
    vals = torch.from_numpy(rng.standard_normal(shape))
    P = tv2.pack_padded(vals, bcs)
    u = [torch.from_numpy(rng.standard_normal(shape)) for _ in range(2)]
    u[0].view(-1)[::7] = 0.0  # the upwind tie
    aux = torch.from_numpy(rng.standard_normal(shape)) if coeffs and coeffs[0] else None
    A = None
    if aux is not None:
        A = torch.from_numpy(rng.standard_normal(tv2.padded_shape(shape)))
        tv2.unpack_padded(A, shape).copy_(aux)
    sp = tuple(1.0 / (n + 1) for n in shape)
    got = twg.weno_stage_general(P, u, sp, shape, coeffs, aux)
    k1 = tv2.unpack_padded(tv2.fused_stage(P, tuple(u), coeffs or twg._BARE, A, sp, shape), shape)
    assert torch.equal(got, k1)


@pytest.mark.parametrize("dims", [2, 3])
def test_flat_field_gives_zero_not_nan(dims):
    shape = (32, 32) if dims == 2 else (8, 9, 10)
    p = torch.ones(tuple(n + 6 for n in shape), dtype=torch.float32)
    u = tuple(torch.full(shape, v, dtype=torch.float32) for v in (1.0, -1.0, 0.0)[:dims])
    out = twg.weno_hamiltonian(p, u, (1.0 / 31,) * dims, shape)
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) < 1e-6


def test_stage_checks():
    shape = (6, 7, 8)
    p = torch.zeros((12, 13, 14), dtype=torch.float64)
    u = tuple(torch.zeros(shape, dtype=torch.float64) for _ in range(3))
    with pytest.raises(ValueError, match="shape"):
        twg.weno_stage_general(p[:-1].contiguous(), u, (0.1,) * 3, shape)
    with pytest.raises(ValueError, match="3 velocity"):
        twg.weno_stage_3d(p, u[:2], (0.1,) * 3, shape)
    with pytest.raises(ValueError, match="contiguous"):
        twg.weno_stage_general(p, (u[0], u[1], torch.zeros(8, 7, 6, dtype=torch.float64)
                                   .permute(2, 1, 0)), (0.1,) * 3, shape)
    with pytest.raises(ValueError, match="2D and 3D"):
        twg.weno_stage_general(torch.zeros(16, dtype=torch.float64),
                               (torch.zeros(10, dtype=torch.float64),), (0.1,), (10,))
    with pytest.raises(ValueError, match="float64"):  # aux in another dtype than the field
        twg.weno_stage_general(p, u, (0.1,) * 3, shape, (1.0, 1.0, 1.0),
                               torch.zeros(shape, dtype=torch.float32))
    # the bare Hamiltonian is the stage at (0, 0, -1)
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.standard_normal((12, 13, 14)))
    u = tuple(torch.from_numpy(rng.standard_normal(shape)) for _ in range(3))
    np.testing.assert_array_equal(_np(twg.weno_hamiltonian(p, u, (0.1,) * 3, shape)),
                                  _np(twg._weno_hamiltonian_plain(p, u, (0.1,) * 3, shape)))


@pytest.mark.parametrize("dims", [2, 3])
def test_rhs_gradients_match_jax(dims):
    """The Function's backward (the plain composite's VJP) against
    ``jax.grad`` of JAX's custom-VJP ``weno_advection_rhs``, float64."""
    shape = (24, 24) if dims == 2 else (10, 12, 14)
    jg, jp, ju, _, tp, tu, _ = _inputs(shape, jnp.float64, torch.float64, seed=7)
    sp = tuple(jg.spacing)

    def jloss(p, u):
        return jnp.sum(jwp.weno_advection_rhs(p, u, sp, shape) ** 2)

    jgp, jgu = jax.grad(jloss, argnums=(0, 1))(jp, ju)
    p = tp.clone().requires_grad_()
    u = tuple(c.clone().requires_grad_() for c in tu)
    loss = (twg.weno_advection_rhs(p, u, sp, shape) ** 2).sum()
    gp, *gu = torch.autograd.grad(loss, (p, *u))
    _close(gp, jgp, 1e-12)
    for a, b in zip(gu, jgu):
        _close(a, b, 1e-12)


@pytest.mark.parametrize("with_aux", [False, True], ids=["noaux", "aux"])
@pytest.mark.parametrize("dims", [2, 3])
def test_stage_gradients_match_jax(dims, with_aux):
    """``weno_advection_stage``'s cotangents for the padded field, the
    velocity, aux and tensor coefficients against ``jax.grad``, float64; a
    velocity that broadcasts (a callable's value) gets its gradient too."""
    shape = (20, 22) if dims == 2 else (9, 10, 12)
    jg, jp, ju, jaux, tp, tu, taux = _inputs(shape, jnp.float64, torch.float64, "extrap2",
                                             seed=11)
    sp = tuple(jg.spacing)
    c0 = (0.75, 0.25, 3e-3)

    def jloss(p, u, aux, cf):
        out = jwp.weno_advection_stage(p, u, aux if with_aux else None, cf, sp, shape)
        return jnp.sum(out ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(jp, ju, jaux, tuple(jnp.asarray(c) for c in c0))
    p = tp.clone().requires_grad_()
    u = tuple(c.clone().requires_grad_() for c in tu)
    aux = taux.clone().requires_grad_()
    cf = tuple(torch.tensor(c, dtype=torch.float64, requires_grad=True) for c in c0)
    out = twg.weno_advection_stage(p, u, aux if with_aux else None, cf, sp, shape,
                                   coeff_values=c0)
    grads = torch.autograd.grad((out ** 2).sum(), (p, *u, aux, *cf), allow_unused=True)
    _close(grads[0], jgrads[0], 1e-12)
    for a, b in zip(grads[1:1 + dims], jgrads[1]):
        _close(a, b, 1e-12)
    if with_aux:
        _close(grads[1 + dims], jgrads[2], 1e-12)
    else:
        assert grads[1 + dims] is None
    for a, b in zip(grads[2 + dims:], jgrads[3]):
        if a is None:  # alpha without aux
            assert not with_aux and float(b) == 0.0
        else:
            np.testing.assert_allclose(float(a), float(b), rtol=1e-12, atol=1e-12)
    # a broadcast velocity component (a scalar) gets the sum of its cotangent
    w = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    u_b = (w,) + tuple(tu[1:])
    (gw,) = torch.autograd.grad(twg.weno_advection_stage(tp, u_b, None, c0, sp, shape).sum(), w)
    full = torch.full(shape, 0.3, dtype=torch.float64, requires_grad=True)
    (gf,) = torch.autograd.grad(twg.weno_advection_stage(tp, (full,) + tuple(tu[1:]), None, c0,
                                                         sp, shape).sum(), full)
    np.testing.assert_allclose(float(gw), float(gf.sum()), rtol=1e-12)


def test_nothing_saved_without_gradients():
    """Without a gradient the entries are the bare kernel calls (no graph)."""
    shape = (8, 9)
    _, _, _, _, tp, tu, _ = _inputs(shape, jnp.float64, torch.float64)
    out = twg.weno_advection_stage(tp, tu, None, (0.0, 1.0, 1e-3), (0.1, 0.1), shape)
    assert out.grad_fn is None
    with torch.no_grad():
        out = twg.weno_advection_rhs(tp.requires_grad_(), tu, (0.1, 0.1), shape)
    assert out.grad_fn is None
