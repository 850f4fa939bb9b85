"""The gradient through the dense 2D fused stepper on the CPU, in float64 at
small ragged sizes: the 2D backward's plain versions (the fold K4, the stage
adjoints K3/K3″ and K3', the shell zeroing K5) against the autograd oracle
of the 2D stage and refresh, a thread-by-thread model of K4's 2D kernel
against the plain fold bit for bit, and ``rollout``'s gradient through the
stepper (``_FusedStepStage`` and the plain twins) against ``jax.grad`` of
JAX's ``rollout`` for configurations 2, 3 and 4. Besides: the error kind of
``Extrapolation(d)`` on an axis of ``n <= d`` nodes, and K4's 3D fold on
axes of 1-3 nodes. All inputs come from numpy seeds.
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
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.ops import weno_v2 as tv2
from lsm_tpu_torch.ops import weno_v2_bwd as tbwd
from test_torch_dense_2d import _CudaTyped

G = tv2.GHOST
E = T.Extrapolation


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


#: the five BC cases of the smoke, and short axes: an axis of 1, 2 or 3 nodes
#: under Extrapolation of degree <= n - 1 (its nodes gather from both faces)
BCS = {"periodic": T.Periodic(), "symmetry": T.Symmetry(), "extrap0": E(0), "extrap2": E(2),
       "mixed": [(T.Symmetry(), E(1)), T.Periodic()],
       "sides": [(E(3), T.Symmetry()), (E(1), E(2))],
       "short": [(E(1), E(2)), (T.Symmetry(), E(0))]}
SHAPES = ((3, 40), (20, 26), (37, 64), (1, 9), (2, 17))


def _cases():
    out = []
    for shape in SHAPES:
        for name, bc in BCS.items():
            bcs = T.normalize_bcs(bc, 2)
            try:
                tv2._ghost_args(bcs, shape)
            except ValueError:
                continue
            out.append((shape, name, bcs))
    return out


CASES = _cases()
IDS = [f"{s[0]}x{s[1]}-{n}" for s, n, _ in CASES]
DTYPES = [torch.float32, torch.float64]


def _bits(x):
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32 else torch.int64)


# -- K4 and K5 on the (n0+6, n1+6) layout ---------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape,name,bcs", CASES, ids=IDS)
def test_plain_fold_2d_is_the_transpose_of_the_refresh(shape, name, bcs, dtype):
    """The plain 2D fold (axis 1's pass over every padded row, then axis 0's
    over the interior columns) is the autograd VJP of ``pack_padded`` of the
    2D field, with zero shells: equal to its round-off (autograd sums a
    node's contributions in an order of its own, so bits may differ by an
    ulp; the kernel is held to the plain fold bit for bit, below)."""
    rng = np.random.default_rng(sum(shape) + len(name))
    g = torch.from_numpy(rng.standard_normal(tv2.padded_shape(shape))).to(dtype)
    got = tbwd.fold_ghost_cotangent_plain(g.clone(), bcs, shape)
    ref = tbwd.fold_ghost_cotangent(g, bcs, shape)
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    assert float((tv2.unpack_padded(got, shape) - ref).abs().max()) <= tol * max(
        float(ref.abs().max()), 1.0)
    shell = torch.ones_like(got, dtype=torch.bool)
    tv2.unpack_padded(shell, shape).fill_(False)
    assert not got[shell].any()


def _fold_args(bcs, shape):
    """K4's arguments as ``launch_fold_2d`` sets them: per axis the kinds,
    degrees, weights in float64 and the bulk's padded range [lo, hi)."""
    kinds, degrees, weights = tv2._ghost_args(bcs, shape)
    w = np.asarray(weights[:]).reshape(3, 2, G, 8)
    lo, hi = [], []
    for ax, n in enumerate(shape):
        reach = max([G + 1] + [degrees[2 * ax + s] + 1 for s in (0, 1)
                               if kinds[2 * ax + s] == 2])
        lo.append(G + reach)
        hi.append(max(G + n - reach, G + reach))
    return list(kinds), list(degrees), w, lo, hi


def fold_2d_thread(g, args, shape, t):
    """What thread ``t`` of ``fold_2d_kernel`` writes: its node of the
    buffer, a row fastest; a ghost 0, a bulk node g, a strip node g plus what
    the scatter adds to it in its order (axis 1's ghosts of its row, then
    axis 0's ghosts of its column with each one's row gathered first), each
    product and sum rounded on its own in g's dtype."""
    kinds, degrees, w, lo, hi = args
    n = shape
    S1 = n[1] + 2 * G
    i, j = divmod(t, S1)
    mi, mj = i - G, j - G
    dt = g.dtype.type
    if not (0 <= mi < n[0] and 0 <= mj < n[1]):
        return dt(0)

    def weight_of(axis, side, k, m):
        kind, P = kinds[2 * axis + side], degrees[2 * axis + side]
        if kind == 0:
            return dt(1) if m == (n[axis] - 1 - k if side == 0 else k) else None
        if kind == 1:
            return dt(1) if m == (k if side == 0 else n[axis] - 1 - k) else None
        jj = m if side == 0 else n[axis] - 1 - m
        return dt(w[axis, side, k - 1, jj]) if jj <= P else None

    def gather(axis, m, x, ghost):
        for side in (0, 1):
            for k in range(1, G + 1):
                wt = weight_of(axis, side, k, m)
                if wt is not None:
                    x = dt(x + dt(wt * ghost(G - k if side == 0 else G + n[axis] - 1 + k)))
        return x

    strip0, strip1 = not lo[0] <= i < hi[0], not lo[1] <= j < hi[1]

    def v1(row):
        return gather(1, mj, g[row, j], lambda p: g[row, p]) if strip1 else g[row, j]

    x = v1(i)
    return gather(0, mi, x, v1) if strip0 else x


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape,name,bcs", CASES, ids=IDS)
def test_fold_2d_thread_model_matches_plain(shape, name, bcs, dtype):
    """K4's 2D kernel, one thread a node of the buffer, emulated thread by
    thread in numpy scalars: bit for bit the plain fold, and every node of
    the new buffer written once (one thread each)."""
    rng = np.random.default_rng(3 * sum(shape) + len(name))
    g = rng.standard_normal(tv2.padded_shape(shape)).astype(
        np.float32 if dtype == torch.float32 else np.float64)
    args = _fold_args(bcs, shape)
    got = np.array([fold_2d_thread(g, args, shape, t) for t in range(g.size)],
                   dtype=g.dtype).reshape(g.shape)
    ref = tbwd.fold_ghost_cotangent_plain(torch.from_numpy(g.copy()), bcs, shape)
    assert torch.equal(_bits(torch.from_numpy(got)), _bits(ref))


@pytest.mark.parametrize("shape", [(3, 40), (20, 26), (1, 9)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_zero_shells_2d_threads_cover_every_ghost_once(shape):
    """K5's 2D kernel: one thread an axis-0 ghost row's node (every column),
    then one an axis-1 ghost of an interior row; they cover the four ghost
    slabs once each, and the plain version zeroes exactly them."""
    n0, n1 = shape
    S1 = n1 + 2 * G
    pos = lambda s6, n: torch.where(s6 < G, s6, n + s6)
    t = torch.arange(2 * G * S1)
    a = pos(t // S1, n0) * S1 + t % S1
    t = torch.arange(n0 * 2 * G)
    b = (G + t // (2 * G)) * S1 + pos(t % (2 * G), n1)
    written = torch.bincount(torch.cat([a, b]), minlength=(n0 + 2 * G) * S1)
    shell = torch.ones(tv2.padded_shape(shape), dtype=torch.bool)
    tv2.unpack_padded(shell, shape).fill_(False)
    assert torch.equal(written, shell.reshape(-1).long())
    buf = torch.from_numpy(np.random.default_rng(2).standard_normal(tv2.padded_shape(shape)))
    out = tbwd.zero_pad_shells(buf.clone(), shape)
    assert not out[shell].any() and torch.equal(out[~shell], buf[~shell])
    assert tbwd.zero_pad_shells.launches == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_fold_fast_2d_on_cpu_returns_a_new_buffer(dtype):
    shape, bcs = (20, 26), T.normalize_bcs(BCS["sides"], 2)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(tv2.padded_shape(shape)))
    g = g.to(dtype)
    before = _bits(g).clone()
    out = tbwd.fold_ghost_cotangent_fast(g, bcs, shape)
    assert out.data_ptr() != g.data_ptr() and torch.equal(_bits(g), before)
    assert torch.equal(out, tbwd.fold_ghost_cotangent_plain(g.clone(), bcs, shape))
    assert tbwd.fold_ghost_cotangent_fast.launches == 0
    with pytest.raises(ValueError, match="3D or 2D"):
        tbwd.fold_ghost_cotangent_fast(g[0], bcs, (shape[1],))


# -- the stage adjoints K3, K3″ and K3' on the 2D layout --------------------------------

ORACLE_BCS = {"periodic": T.Periodic(), "symmetry": T.Symmetry(), "extrap1": E(1)}
LO2 = (0.1, -0.2)


def _field(shape, bc, seed, lo=(0.0, 0.0), hi=(1.0, 1.3)):
    rng = np.random.default_rng(seed)
    grid = T.Grid(lo, hi, shape)
    phi = T.MeshField(torch.from_numpy(rng.standard_normal(shape)), grid, bc)
    aux = tv2.pack_padded(torch.from_numpy(rng.standard_normal(shape)), phi.bcs)
    g = torch.from_numpy(rng.standard_normal(tv2.padded_shape(shape)))
    return rng, phi, aux, g


def _velocity(kind, phi, rng):
    """One advection term of the 2D stage: streamed (two components, a few
    exact zeros: upwind ties), the rotation or the time-dependent vortex as
    the embedding's programs (what the stepper traces)."""
    if kind == "stream":
        vel = 0.3 * rng.standard_normal((2, *phi.shape))
        vel[1, :, ::4] = 0.0
        return tv2.TermSpec("advection", "stream", None, 2), tuple(torch.from_numpy(v.copy())
                                                                   for v in vel)
    fn = {"rotation": tshapes.rigid_rotation_velocity((0.5, 0.5), 2.0 * math.pi),
          "vortex": tshapes.vortex_velocity(period=4.0)}[kind]
    (entry,) = tfused.term_entries((T.AdvectionTerm(fn),), phi, embed=False)
    assert entry[0].coef_kind == "program"
    return entry


def _oracle(P, terms, coeffs, aux, g, phi, where):
    return tbwd.composite_backward_autograd(P, terms, coeffs, aux, g, phi.bcs, phi.spacing,
                                            phi.shape, where)


def _check(got, ref, tol=1e-12):
    assert _rel(got[0], ref[0]) <= tol  # raw dP: ghost positions included
    for a, b in zip(got[1] or (), ref[1]):
        assert _rel(a, b) <= tol if float(b.abs().max()) > 0 else not a.any()
    assert got[2].shape == ref[2].shape and _rel(got[2], ref[2]) <= tol
    if ref[3] is None:
        assert got[3] is None
    else:
        assert _rel(got[3], ref[3]) <= tol


@pytest.mark.parametrize("with_aux", [False, True], ids=["noaux", "aux"])
@pytest.mark.parametrize("velocity", ["stream", "rotation", "vortex"])
@pytest.mark.parametrize("bc", list(ORACLE_BCS))
def test_stage_backward_2d_matches_autograd_oracle(bc, velocity, with_aux):
    """K3's (and K3″'s) plain 2D version on the folded cotangent against
    autograd of the plain 2D stage and refresh, in float64 within 1e-12 of
    max|ref|: raw dP, the two stream cotangents, dcoef (the stage time's
    cotangent through the vortex's program) and daux."""
    shape = (20, 26)
    rng, phi, aux, g = _field(shape, ORACLE_BCS[bc], seed=len(bc) + len(velocity))
    P = tv2.pack_padded(phi.values, phi.bcs)
    spec, arrs = _velocity(velocity, phi, rng)
    aux = aux if with_aux else None
    coeffs = (0.75, 0.25, 0.03) if with_aux else (0.0, 1.0, 0.03)
    where = tv2.Where(LO2, None, 0.37)
    gf = tbwd.fold_ghost_cotangent_fast(g, phi.bcs, shape)
    u = arrs if spec.coef_kind == "stream" else spec.coef_static
    got = tbwd.stage_backward(P, u, coeffs, aux, gf, phi.spacing, shape, where=where,
                              need_dt=True)
    ref = _oracle(P, ((spec, arrs),), coeffs, aux, g, phi, where)
    _check(got, ref)
    assert (got[1] is None) == (spec.coef_kind == "program")
    if velocity == "vortex":
        assert abs(float(got[2][3])) > 0  # the time's cotangent reaches dcoef
    # the stage reads stored face ghosts: dP lives there, not on the corners
    assert float(got[0][:G, G:-G].abs().max()) > 0 and not got[0][:G, :G].any()


#: 2D term lists of K1''s 2D stage: config 4's curvature + streamed normal
#: motion, the eikonal kind's two sign forms, a time-dependent program speed
#: beside a streamed curvature, and an advection term beside normal motion
LISTS = {
    "config 4": lambda phi, s: (T.CurvatureTerm(-0.05), T.NormalMotionTerm(T.MeshField(s, phi.grid))),
    "eikonal none": lambda phi, s: (T.EikonalReinitializationTerm(),),
    "eikonal frozen": lambda phi, s: (T.EikonalReinitializationTerm(T.MeshField(s, phi.grid)),),
    "program + dt": lambda phi, s: (T.NormalMotionTerm(lambda xs, t: 0.1 + 0.05 * xs[0]
                                                       + 0.02 * t * xs[1]),
                                    T.CurvatureTerm(T.MeshField(s, phi.grid))),
    "advection + normal": lambda phi, s: (
        T.AdvectionTerm(T.MeshField(torch.stack([0.3 * s, -0.2 * s]), phi.grid)),
        T.NormalMotionTerm(T.MeshField(s, phi.grid))),
}


@pytest.mark.parametrize("with_aux", [False, True], ids=["noaux", "aux"])
@pytest.mark.parametrize("name", list(LISTS))
@pytest.mark.parametrize("bc", ["periodic", "extrap1"])
def test_stage_backward_terms_2d_match_autograd_oracle(bc, name, with_aux):
    """K3''s plain 2D version and the CPU twin of its staged factorisation
    on the folded cotangent against autograd of the plain 2D stage and
    refresh, float64, within 1e-12 of max|ref|: raw dP (tie-free BCs), the
    stream cotangents, dcoef (with the stage time's cotangent) and daux."""
    shape = (20, 26)
    rng, phi, aux, g = _field(shape, ORACLE_BCS[bc], seed=len(name) + 3 * len(bc))
    s = torch.from_numpy(0.2 + 0.05 * rng.standard_normal(shape))
    terms = tfused.term_entries(LISTS[name](phi, s), phi, embed=False)
    P = tv2.pack_padded(phi.values, phi.bcs)
    aux = aux if with_aux else None
    coeffs = (0.75, 0.25, 0.03) if with_aux else (0.0, 1.0, 0.03)
    where = tv2.Where(LO2, None, 0.37)
    gf = tbwd.fold_ghost_cotangent_fast(g, phi.bcs, shape)
    ref = _oracle(P, terms, coeffs, aux, g, phi, where)
    for fn in (tbwd.stage_backward_terms, tbwd.stage_backward_terms_staged):
        got = fn(P, terms, coeffs, aux, gf, phi.spacing, shape, where=where, need_dt=True)
        _check(got, ref)
    assert tbwd.stage_backward_terms.launches == 0


def test_2d_backward_checks_its_arguments():
    shape = (8, 9)
    bcs = T.normalize_bcs(T.Periodic(), 2)
    P = torch.zeros(tv2.padded_shape(shape), dtype=torch.float64)
    u = (torch.zeros(shape, dtype=torch.float64),) * 3
    with pytest.raises(ValueError, match="one velocity component per axis"):
        tbwd.stage_backward(P, u, (0.0, 1.0, 0.1), None, P, (0.1, 0.1), shape)
    with pytest.raises(ValueError, match="one spacing per axis"):
        tbwd.stage_backward_terms(P, u[:2], (0.0, 1.0, 0.1), None, P, (0.1, 0.1, 0.1), shape)
    with pytest.raises(ValueError, match="3D or 2D"):
        tbwd.zero_pad_shells(P[0], (shape[1],))
    out = tbwd.zero_pad_shells(P.clone() + 1.0, shape)
    assert float(out.sum()) == float(np.prod(shape)) and tbwd.zero_pad_shells.launches == 0
    assert tbwd.fold_ghost_cotangent_fast(P, bcs, shape).shape == P.shape


# -- rollout's gradient through the 2D stepper against JAX -------------------------------


def _config(m, cfg, shape):
    """Configuration ``cfg`` (2 Zalesak, 2s the same with its velocity
    sampled on the grid, 3 vortex, 4 star with a streamed speed 0.2 + 0.05 x)
    of ``models.benchmarks`` on a ``shape`` grid for the package ``m``:
    ``(phi, make_terms(speed))``; both packages' phi hold the JAX sample's
    values plus the same seeded noise (no exact upwind or minmod ties)."""
    pkg, sh = (J, jshapes) if m is jnp else (T, tshapes)
    lo, hi = ((-1.0, -1.0), (1.0, 1.0)) if cfg == 4 else ((0.0, 0.0), (1.0, 1.0))
    fn = {2: jshapes.zalesak_disk(), "2s": jshapes.zalesak_disk(),
          3: jshapes.circle((0.5, 0.75), 0.15), 4: jshapes.star()}[cfg]
    vals = np.asarray(J.sample(fn, J.Grid(lo, hi, shape), dtype=jnp.float64).values)
    vals = vals + 1e-6 * np.random.default_rng(sum(shape)).standard_normal(shape)
    bc = pkg.Periodic() if cfg in (2, "2s") else pkg.Extrapolation(2)
    grid = pkg.Grid(lo, hi, shape)
    values = jnp.asarray(vals) if m is jnp else torch.from_numpy(vals.copy())
    rot = sh.rigid_rotation_velocity((0.5, 0.5), 2.0 * math.pi)

    def make_terms(speed):
        if cfg == 4:
            return (pkg.CurvatureTerm(-0.05), pkg.NormalMotionTerm(pkg.MeshField(speed, grid)))
        if cfg == 2:
            return (pkg.AdvectionTerm(rot),)
        if cfg == "2s":
            xs = np.meshgrid(*(np.linspace(a, b, n) for a, b, n in zip(lo, hi, shape)),
                             indexing="ij")
            vel = np.stack([np.asarray(c) for c in jshapes.rigid_rotation_velocity(
                (0.5, 0.5), 2.0 * math.pi)(tuple(jnp.asarray(x) for x in xs), 0.0)])
            vel = jnp.asarray(vel) if m is jnp else torch.from_numpy(vel)
            return (pkg.AdvectionTerm(pkg.MeshField(vel, grid)),)
        return (pkg.AdvectionTerm(sh.vortex_velocity(period=4.0)),)

    return pkg.MeshField(values, grid, bc), make_terms


def _speed0(shape):
    xs = np.linspace(-1.0, 1.0, shape[0])[:, None] + np.zeros(shape)
    return 0.2 + 0.05 * xs


@pytest.mark.parametrize("cfg", [2, "2s", 3, 4], ids=["2", "2s", "3", "4"])
def test_rollout_gradient_2d_matches_jax(cfg, monkeypatch):
    """``rollout`` (RK3, remat) through the dense 2D stepper, its every
    stage a ``_FusedStepStage`` (backward: K4, K3/K3″ or K3' and K5, here
    their plain versions), against ``jax.grad`` of JAX's ``rollout`` on the
    same inputs: the gradient with respect to phi0 (and, for configuration
    4, the streamed speed) within 1e-9 of its max."""
    shape, nsteps = ((20, 26), 3) if cfg != 4 else ((22, 24), 2)
    jphi, jterms = _config(jnp, cfg, shape)
    tphi, tterms = _config(torch, cfg, shape)
    dt = 0.1 * min(jphi.grid.spacing) if cfg != 4 else 1e-3
    s0 = _speed0(shape)

    def jloss(v, s):
        out, _ = J.rollout(J.RK3(), jterms(s), jphi.with_values(v), 0.0, dt, nsteps, fast="off")
        return jnp.sum(out.values ** 2)

    jg = [np.asarray(x) for x in jax.grad(jloss, argnums=(0, 1))(jphi.values, jnp.asarray(s0))]
    applied = []
    apply = tv2._FusedStepStage.apply
    monkeypatch.setattr(tv2._FusedStepStage, "apply",
                        lambda *a: applied.append(1) or apply(*a))
    v = tphi.values.clone().requires_grad_()
    s = torch.from_numpy(s0).requires_grad_()
    terms = tterms(s)
    assert tfused.unsupported_reason(terms, tphi, T.RK3()) is None
    assert tfused.gradient_reason(terms, tphi) is None
    out, _ = T.rollout(T.RK3(), terms, tphi.with_values(v), 0.0, dt, nsteps, remat=True)
    grads = torch.autograd.grad((out.values ** 2).sum(), (v, s) if cfg == 4 else (v,))
    assert len(applied) >= 3 * nsteps  # every stage of the forward (remat: again)
    for got, want in zip(grads, jg):
        assert _rel(_np(got), want) <= 1e-9


# -- the error kind of a short axis, and K4's 3D fold on axes of 1-3 nodes -------------


def test_extrapolation_short_of_nodes_is_a_value_error():
    """``Extrapolation(d)`` on an axis of ``n <= d`` nodes is an error, as in
    JAX (``ValueError``, "needs d + 1 nodes"), not a pending port: its reason
    names no ROADMAP item, a CUDA state takes the general path and raises
    ``ValueError`` there; a degree > 7 on an axis that has its nodes takes
    the fused route, whose gradient (through K4's plain version, the table
    route's function) equals the general path's and ``jax.grad``'s."""
    grid = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (3, 8, 9))
    phi = T.MeshField(torch.zeros(3, 8, 9, dtype=torch.float64), grid, E(3))
    term = T.AdvectionTerm(lambda xs, t: (0.0 * xs[0], 0.0 * xs[1], 1.0 + 0.0 * xs[2]))
    reason = tfused.unsupported_reason((term,), phi, T.RK3())
    assert "needs 4 nodes" in reason and "queue 2" not in reason
    cuda = phi.with_values(phi.values.as_subclass(_CudaTyped))
    eq = T.LevelSetEquation(terms=term, ic=cuda)
    assert cuda.values.is_cuda and eq._cuda_stepper(False, "auto") is None
    with pytest.raises(ValueError, match="needs 4 nodes"):
        eq.integrate(0.1, max_steps=1)
    with pytest.raises(ValueError, match="needs 4 nodes"):
        T.rollout(T.RK3(), (term,), cuda, 0.0, 1e-3, 1)
    with pytest.raises(ValueError, match="needs 4 nodes"):  # JAX's error
        jbc.pad_ghost(jnp.zeros((3, 8, 9)), J.normalize_bcs(J.Extrapolation(3), 3), 3)
    shape = (9, 9, 9)
    vals = np.random.default_rng(8).standard_normal(shape)
    deep = T.MeshField(torch.from_numpy(vals), T.Grid((0.0,) * 3, (1.0,) * 3, shape), E(8))
    assert tfused.unsupported_reason((term,), deep, T.RK3()) is None
    cuda = deep.with_values(deep.values.as_subclass(_CudaTyped))
    assert isinstance(T.LevelSetEquation(terms=term, ic=cuda)._cuda_stepper(False, "auto"),
                      tfused.FusedStepper)
    with pytest.raises(ValueError, match=r"degree \+ 1 <= n"):  # too few nodes
        tv2._ghost_args(phi.bcs, phi.shape)
    dt, w = 2e-3, np.random.default_rng(9).standard_normal(shape)
    grads = []
    for fast in ("auto", "off"):
        v = torch.from_numpy(vals).requires_grad_()
        out, _ = T.rollout(T.RK3(), (term,), deep.with_values(v), 0.0, dt, 2, fast=fast)
        grads.append(torch.autograd.grad((out.values * torch.from_numpy(w)).sum(), v)[0])
    jterm = J.AdvectionTerm(lambda xs, t: (0.0 * xs[0], 0.0 * xs[1], 1.0 + 0.0 * xs[2]))
    jphi = J.MeshField(jnp.asarray(vals), J.Grid((0.0,) * 3, (1.0,) * 3, shape),
                       J.Extrapolation(8))

    def jloss(v):
        out, _ = J.rollout(J.RK3(), (jterm,), jphi.with_values(v), 0.0, dt, 2, fast="off")
        return jnp.sum(out.values * jnp.asarray(w))

    jg = np.asarray(jax.grad(jloss)(jphi.values))
    for g in grads:
        assert _rel(_np(g), jg) <= 1e-10


def _fold_gather_3d(g, bcs, shape):
    """K4's 3D design as a gather (``fold_node``): V2 = g + axis 2's
    contributions, V1 = V2 + w V2(ghost) over axis 1, the interior V1 + w
    V1(ghost) over axis 0; the shells 0."""
    kinds, degrees, w, _, _ = _fold_args(bcs, shape)
    out = torch.zeros_like(g)
    dt = g.dtype

    def gather(axis, v, src_of):
        n = shape[axis]
        for side in (0, 1):
            kind, P = kinds[2 * axis + side], degrees[2 * axis + side]
            for k in range(1, G + 1):
                p = G - k if side == 0 else G + n - 1 + k
                for m in range(n):
                    if kind == 0:
                        wt = 1.0 if m == (n - 1 - k if side == 0 else k) else None
                    elif kind == 1:
                        wt = 1.0 if m == (k if side == 0 else n - 1 - k) else None
                    else:
                        j = m if side == 0 else n - 1 - m
                        wt = float(w[axis, side, k - 1, j]) if j <= P else None
                    if wt is not None:
                        idx = [slice(None)] * 3
                        idx[axis] = m
                        v[tuple(idx)] = v[tuple(idx)] + torch.tensor(wt, dtype=dt) * src_of(p)
        return v

    n0, n1, n2 = shape
    v2_ = g[:, :, G:G + n2].clone()
    v2_ = gather(2, v2_, lambda p: g[:, :, p])
    v1 = v2_[:, G:G + n1].clone()
    v1 = gather(1, v1, lambda p: v2_[:, p])
    x = v1[G:G + n0].clone()
    x = gather(0, x, lambda p: v1[p])
    tv2.unpack_padded(out, shape).copy_(x)
    return out


SHORT_3D = [((3, 24, 40), E(2)), ((1, 9, 10), E(0)), ((2, 5, 3), [E(1), (E(0), E(4)), E(2)])]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape,bc", SHORT_3D, ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else None)
def test_fold_3d_short_axes(shape, bc, dtype):
    """K4's 3D design on axes of 1-3 nodes (no bulk there: a node gathers
    from both faces) equals the plain fold bit for bit, the plain fold is
    autograd's transpose of the refresh, the kernel's threads still cover
    every node once, and a gradient through such a 3D field is no longer
    refused on CUDA."""
    bcs = T.normalize_bcs(bc, 3)
    rng = np.random.default_rng(sum(shape))
    g = torch.from_numpy(rng.standard_normal(tv2.padded_shape(shape))).to(dtype)
    ref = tbwd.fold_ghost_cotangent_plain(g.clone(), bcs, shape)
    assert torch.equal(_bits(_fold_gather_3d(g, bcs, shape)), _bits(ref))
    auto = tbwd.fold_ghost_cotangent(g, bcs, shape)
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    assert float((tv2.unpack_padded(ref, shape) - auto).abs().max()) <= tol * max(
        float(auto.abs().max()), 1.0)
    # the kernel's threads: the flat pass (ghosts and bulk rows), then one a
    # node of the strip rows (planes outside the bulk's axis-0 range, rows
    # outside its axis-1 range in the planes within it)
    _, _, _, lo, hi = _fold_args(bcs, shape)
    n0, n1, n2 = shape
    S = tv2.padded_shape(shape)
    i, j = torch.meshgrid(torch.arange(S[0]), torch.arange(S[1]), indexing="ij")
    interior = torch.zeros(S, dtype=torch.bool)
    tv2.unpack_padded(interior, shape).fill_(True)
    bulk_row = ((i >= lo[0]) & (i < hi[0]) & (j >= lo[1]) & (j < hi[1]))[:, :, None]
    flat = ~interior | (bulk_row.expand(S) & interior)
    B0, B1, lo0, lo1 = hi[0] - lo[0], hi[1] - lo[1], lo[0] - G, lo[1] - G
    t = torch.arange((n0 - B0) * n1 * n2)
    row, mk = t // n2, t % n2
    p, mj = row // n1, row % n1
    planes = ((G + torch.where(p < lo0, p, p + B0)) * S[1] + G + mj) * S[2] + G + mk
    t = torch.arange(B0 * (n1 - B1) * n2)
    q, mk = t // n2, t % n2
    ii, jj = q // max(n1 - B1, 1), q % max(n1 - B1, 1)
    rows = ((G + lo0 + ii) * S[1] + G + torch.where(jj < lo1, jj, jj + B1)) * S[2] + G + mk
    written = flat.reshape(-1).long() + torch.bincount(torch.cat([planes, rows]),
                                                       minlength=flat.numel())
    assert torch.equal(written, torch.ones_like(written))
    if min(shape) >= 2:  # a grid has at least 2 nodes an axis
        phi = T.MeshField(torch.zeros(shape, dtype=torch.float64),
                          T.Grid((0.0,) * 3, (1.0,) * 3, shape), bc)
        term = T.AdvectionTerm(lambda xs, t: (0.1 + 0.0 * xs[0], 0.0 * xs[1], 0.2 + 0.0 * xs[2]))
        assert tfused.gradient_reason((term,), phi) is None
