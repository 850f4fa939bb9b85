"""The forward stage (K1, K1″) at the shapes its march treats apart, on the
CPU in float64: the 2D embedding ``(1, n0, n1)``, an axis 0 that is not a
multiple of JAX's tile (8) or of the march's chunk (64), and columns that
tile neither axis 1 (16) nor axis 2 (32). ``fused_stage`` (its plain version
on CPU tensors) is held against JAX's Pallas stage in interpret mode where
JAX's tiles take the shape (its lane axis needs 128 nodes), and against
JAX's ``stage_reference`` everywhere; a streamed velocity (K1) and traced
programs (K1″) at a nonzero origin, with and without aux. On the embedding
the plain stage equals, bit for bit, the plain stage without its axis-0
term: the ground on which the kernel compiles axis 0 out when ``n0 == 1``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.ops import weno_v2 as jv2
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.ops import coef_program as cp
from lsm_tpu_torch.ops import stencils as tst
from lsm_tpu_torch.ops import weno_v2 as tv2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


ORIGIN = (3.0, -5.0, 7.0)
LO = (-0.2, 0.1, 0.0)


def _rotation(m):
    """The flagship's rotation: u0 reads axis 1 only, u1 axis 0 only, u2 is
    constant (the march evaluates them per column, per plane, per column)."""
    return lambda xs, t: (0.5 - xs[1] + 0.0 * (xs[0] + xs[2]),
                          xs[0] - 0.5 + 0.0 * (xs[1] + xs[2]),
                          0.1 + 0.3 * t + 0.0 * (xs[0] + xs[1] + xs[2]))


def _vortex(m):
    """Config 3's swirl in x-y, reversing in time, and a drift along z: u0
    and u1 read axes 0 and 1 (the march evaluates them per node)."""
    def f(xs, t):
        x, y, z = xs
        arg = math.pi * t / 4.0
        mod = math.cos(arg) if isinstance(arg, float) else m.cos(arg)
        return (-(m.sin(math.pi * x) ** 2) * m.sin(2.0 * math.pi * y) * mod + 0.0 * z,
                m.sin(2.0 * math.pi * x) * m.sin(math.pi * y) ** 2 * mod + 0.0 * z,
                0.1 + 0.2 * t + 0.0 * (x + y + z))
    return f


VELOCITIES = {"rotation": _rotation, "vortex": _vortex}


def _bcs(pkg, shape):
    """The embedding's BCs for ``n0 == 1`` (``Extrapolation(0)`` on the
    length-1 axis, whose ghosts then copy the plane), else mixed ones."""
    if shape[0] == 1:
        return ((pkg.Extrapolation(0), pkg.Extrapolation(0)),
                *pkg.normalize_bcs([pkg.Periodic(), (pkg.Extrapolation(2), pkg.Symmetry())], 2))
    return pkg.normalize_bcs([(pkg.Symmetry(), pkg.Extrapolation(1)), pkg.Periodic(),
                              (pkg.Extrapolation(2), pkg.Symmetry())], 3)


def _spacing(shape):
    return tuple(1.3 / max(n - 1, 1) if n > 1 else 0.05 for n in shape)


def _case(shape, velocity, with_aux, seed):
    """The same inputs for both packages: padded phi (and aux) from seeded
    numpy values, the term lists (JAX's analytic or streamed spec, the
    port's program or streams), the coefficients and ``(t, origin)``."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(shape)
    aux = rng.standard_normal(shape) if with_aux else None
    jb, tb = _bcs(J, shape), _bcs(T, shape)
    JP, TP = jv2.pack_padded(jnp.asarray(vals), jb), tv2.pack_padded(torch.from_numpy(vals), tb)
    JA = None if aux is None else jv2.pack_padded(jnp.asarray(aux), jb)
    TA = None if aux is None else tv2.pack_padded(torch.from_numpy(aux), tb)
    if velocity == "stream":
        u = rng.standard_normal((3, *shape))
        u[1, :, :, ::5] = 0.0  # tie cells
        jterms = ((jv2.TermSpec("advection", "stream", None, 3),
                   tuple(jnp.asarray(u[d]) for d in range(3))),)
        tterms = ((tv2.TermSpec("advection", "stream", None, 3),
                   tuple(torch.from_numpy(u[d]).contiguous() for d in range(3))),)
        origin = None
    else:
        prog = cp.trace(VELOCITIES[velocity](torch), 3, 3)
        assert isinstance(prog, cp.Program), prog
        jterms = ((jv2.TermSpec("advection", "analytic", VELOCITIES[velocity](jnp), 0), ()),)
        tterms = ((tv2.TermSpec("advection", "program", prog), ()),)
        origin = ORIGIN
    coeffs = (0.75, 0.25, 2.5e-3) if with_aux else (0.0, 1.0, 1e-2)
    return (JP, JA, jb), (TP, TA, tb), jterms, tterms, coeffs, (0.3, origin)


def _check(shape, velocity, with_aux, seed, interpret):
    (JP, JA, jb), (TP, TA, tb), jterms, tterms, coeffs, (t, origin) = _case(
        shape, velocity, with_aux, seed)
    sp = _spacing(shape)
    out = tv2.fused_stage(TP, tterms, coeffs, TA, sp, shape, tv2.Where(LO, origin, t))
    assert tv2.fused_stage.launches == 0  # CPU tensors run the plain version
    got = _np(tv2.unpack_padded(out, shape))
    refs = [np.asarray(jv2.stage_reference(JP, jterms, coeffs, t, JA, jb, sp, shape, LO,
                                           origin=origin))]
    if interpret:
        refs.append(np.asarray(jv2.unpack_padded(jv2.fused_stage(
            JP, jterms, coeffs, t, JA, jb, sp, shape, LO, interpret=True, origin=origin), shape)))
    for ref in refs:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-11 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("with_aux", [False, True], ids=["noaux", "aux"])
@pytest.mark.parametrize("velocity", ["stream", "rotation", "vortex"])
@pytest.mark.parametrize("shape", [(1, 16, 128), (12, 16, 128), (5, 8, 128)],
                         ids=["embedding", "n0_12", "n0_5"])
def test_stage_matches_jax_interpret(shape, velocity, with_aux):
    """JAX's Pallas stage in interpret mode (B0 = 1 on the embedding and at
    n0 = 5, B0 = 4 at n0 = 12) and its oracle against the port's stage."""
    _check(shape, velocity, with_aux, seed=sum(shape), interpret=True)


@pytest.mark.parametrize("velocity", ["stream", "rotation", "vortex"])
@pytest.mark.parametrize("shape", [(1, 37, 75), (67, 37, 75), (130, 20, 33)],
                         ids=["embedding", "two_chunks", "three_chunks"])
def test_stage_matches_jax_reference_on_ragged_shapes(shape, velocity):
    """Shapes JAX's tiles do not take (ragged columns; 67 and 130 planes are
    two and three chunks of the march): JAX's oracle, with aux."""
    _check(shape, velocity, True, seed=sum(shape), interpret=False)


def _stage_without_axis0(P, u, coeffs, aux, spacing, shape):
    """The plain stage with the axis-0 term left out: the sum over axes 1 and
    2 in the plain version's own order."""
    alpha, beta, gamma = coeffs
    ham = 0.0
    for ax in (1, 2):
        ham = ham + tst.weno5_upwind(
            tst.weno5_pair_diffs(P, ax, float(spacing[ax]), tv2.GHOST, shape), u[ax])
    res = beta * tst.shift(P, (0, 0, 0), tv2.GHOST, shape) - gamma * ham
    if aux is not None:
        res = alpha * tv2.unpack_padded(aux, shape) + res
    return res


@pytest.mark.parametrize("with_aux", [False, True], ids=["noaux", "aux"])
@pytest.mark.parametrize("bc", ["periodic", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_embedding_stage_has_no_axis0_term(dtype, bc, with_aux):
    """On the embedding ``(1, n0, n1)`` of a 2D field (the stepper's own BCs,
    ``Extrapolation(0)`` on the length-1 axis) every axis-0 difference is
    exactly zero, whatever u0, so the plain stage equals the plain stage
    without its axis-0 term bit for bit."""
    grid = T.Grid((0.0, -0.5), (1.0, 0.7), (24, 40))
    bcs2 = T.normalize_bcs(T.Periodic() if bc == "periodic" else
                           [(T.Symmetry(), T.Extrapolation(2)), T.Extrapolation(1)], 2)
    phi = T.MeshField(torch.from_numpy(
        np.random.default_rng(5).standard_normal(grid.shape)).to(dtype), grid, bcs2)
    shape, bcs, spacing, _ = tfused.embed_2d(phi)
    rng = np.random.default_rng(6)
    P = tv2.pack_padded(phi.values.reshape(shape), bcs)
    u = tuple(torch.from_numpy(rng.standard_normal(shape)).to(dtype) for _ in range(3))
    aux = tv2.pack_padded(torch.from_numpy(rng.standard_normal(shape)).to(dtype), bcs) \
        if with_aux else None
    coeffs = (0.75, 0.25, 2.5e-3) if with_aux else (0.0, 1.0, 1e-2)
    assert not any(d.any() for d in tst.weno5_pair_diffs(P, 0, float(spacing[0]), tv2.GHOST,
                                                         shape))
    got = tv2.unpack_padded(tv2.stage_plain(P, u, coeffs, aux, spacing, shape), shape)
    want = _stage_without_axis0(P, u, coeffs, aux, spacing, shape)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(got.contiguous().view(bits), want.contiguous().view(bits))


def _exp_x0_z(xs, t):
    return (torch.exp(xs[0]) * xs[2], 2.0 + t + 0.0 * xs[1], xs[1] * xs[1] + xs[2])


@pytest.mark.parametrize("fn,want", [(_rotation(torch), (2, 1, 0)), (_vortex(torch), (3, 3, 0)),
                                     (_exp_x0_z, (5, 0, 6))],
                         ids=["rotation", "vortex", "tables"])
def test_program_axes(fn, want):
    """``Program.axes``, which chooses how K1″'s march evaluates each
    component (per column, per plane or per node), holds the axes each
    component reads: the coordinates and per-axis tables of its ops (a leaf
    loaded, pushed or taken as a binary op's immediate)."""
    prog = cp.trace(fn, 3, 3)
    assert isinstance(prog, cp.Program), prog
    assert prog.axes == want
    for comp, axes in zip(prog.components, prog.axes):
        leaves = [arg if mode == "imm" else (op, arg) for op, arg, mode in comp]
        read = {arg for op, arg in leaves if op == "x"}
        read |= {prog.tables[arg][1] for op, arg in leaves if op == "tab"}
        assert sum(1 << d for d in read - {-1}) == axes
