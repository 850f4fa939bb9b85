"""Parity of the PyTorch port's core modules with the JAX package, on the CPU
in float64: grid, boundary conditions and ghost padding, sampling, the WENO5
stencils, geometry queries, shapes and checkpoints.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.core import bc as jbc
from lsm_tpu.geometry import queries as jgeo
from lsm_tpu.models import shapes as jshapes
from lsm_tpu.ops import stencils as jst
from lsm_tpu.utils import checkpoint as jckpt
from lsm_tpu_torch.core import bc as tbc
from lsm_tpu_torch.geometry import queries as tgeo
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.ops import stencils as tst
from lsm_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the suite runs under xdist with several workers on a few cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bc_pair(pkg, spec):
    """A BC built in one package from a package-neutral spec."""
    kind, deg = spec
    if kind == "periodic":
        return pkg.Periodic()
    if kind == "symmetry":
        return pkg.Symmetry()
    return pkg.Extrapolation(deg)


def _bcs(pkg, specs):
    return tuple((_bc_pair(pkg, l), _bc_pair(pkg, r)) for l, r in specs)


P_ = ("periodic", 0)
S_ = ("symmetry", 0)


def E(d):
    return ("extrapolation", d)


BC_CASES = (
    [[(P_, P_)] * 3, [(S_, S_)] * 3]
    + [[(E(d), E(d))] * 3 for d in range(8)]
    + [[(S_, E(1)), (P_, P_), (E(3), S_)], [(E(7), E(0)), (S_, E(5)), (E(2), P_)],
       [(P_, P_), (E(6), S_), (S_, E(4))]]
)


def _case_id(specs):
    return "-".join(f"{l[0][0]}{l[1]}{r[0][0]}{r[1]}" for l, r in specs)


@pytest.mark.parametrize("specs", BC_CASES, ids=[_case_id(c) for c in BC_CASES])
def test_pad_ghost_matches_jax(specs):
    rng = np.random.default_rng(7)
    v = rng.standard_normal((9, 10, 11))
    for width in (1, 3):
        got = tbc.pad_ghost(torch.from_numpy(v), _bcs(T, specs), width)
        ref = jbc.pad_ghost(jnp.asarray(v), _bcs(J, specs), width)
        assert got.shape == ref.shape
        # degree-7 corners of white noise reach ~1e4; the two packages sum the
        # Lagrange terms in another order, so the bound is 1e-12 of the scale
        scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("bc", ["periodic", "symmetry", "neumann", "linear"])
def test_pad_ghost_2d_matches_jax(bc):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((12, 13))
    make = {"periodic": lambda p: p.Periodic(), "symmetry": lambda p: p.Symmetry(),
            "neumann": lambda p: p.Neumann(), "linear": lambda p: p.LinearExtrapolation()}[bc]
    got = tbc.pad_ghost(torch.from_numpy(v), T.normalize_bcs(make(T), 2), 3)
    ref = jbc.pad_ghost(jnp.asarray(v), J.normalize_bcs(make(J), 2), 3)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-12)


def test_lagrange_weights_match_jax():
    for P in range(8):
        np.testing.assert_array_equal(tbc._lagrange_extrap_weights(3, P),
                                      jbc._lagrange_extrap_weights(3, P))


def test_normalize_bcs_errors_match_jax():
    for pkg in (T, J):
        with pytest.raises(ValueError, match="periodic"):
            pkg.normalize_bcs([(pkg.Periodic(), pkg.Symmetry()), pkg.Periodic()], 2)
        with pytest.raises(ValueError, match="number of boundary conditions"):
            pkg.normalize_bcs([pkg.Periodic()], 2)
        with pytest.raises(ValueError, match="invalid boundary condition"):
            pkg.normalize_bcs([(pkg.Periodic(),), pkg.Periodic()], 2)
        with pytest.raises(ValueError, match="degree"):
            pkg.Extrapolation(-1)
    with pytest.raises(ValueError, match="needs 4 nodes"):
        tbc.pad_ghost(torch.zeros(3, 5), T.normalize_bcs(T.Extrapolation(3), 2), 1)
    assert tbc.bcs_str(T.normalize_bcs(T.Periodic(), 3)) == jbc.bcs_str(
        J.normalize_bcs(J.Periodic(), 3))


def test_grid_matches_jax():
    args = ((-1.0, 0.0, 0.5), (1.0, 2.0, 3.0), (5, 7, 9))
    tg, jg = T.Grid(*args), J.Grid(*args)
    assert tg.spacing == jg.spacing
    assert tg.min_spacing == jg.min_spacing
    assert tg.cell_volume == jg.cell_volume
    for a, b in zip(tg.coords(torch.float64, device="cpu"), jg.coords(jnp.float64)):
        assert a.shape == b.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-15)
    with pytest.raises(ValueError):
        T.Grid((0.0,), (1.0,), (1,))


def test_sample_and_shapes_match_jax():
    args = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (10, 12, 14))
    tphi = T.sample(tshapes.zalesak_sphere(), T.Grid(*args), T.Periodic(),
                    dtype=torch.float64, device="cpu")
    jphi = J.sample(jshapes.zalesak_sphere(), J.Grid(*args), J.Periodic(),
                    dtype=jnp.float64)
    np.testing.assert_allclose(_np(tphi.values), np.asarray(jphi.values), rtol=0, atol=1e-12)
    assert tphi.bcs == T.normalize_bcs(T.Periodic(), 3)
    f = lambda *xs: (xs[0] * 0 + 1.0, xs[1] * 2.0, xs[2] - 0.5)
    tv = T.sample(f, T.Grid(*args), dtype=torch.float64, device="cpu")
    jv = J.sample(f, J.Grid(*args), dtype=jnp.float64)
    assert tv.is_vector and tv.values.shape == (3, 10, 12, 14)
    np.testing.assert_allclose(_np(tv.values), np.asarray(jv.values), rtol=0, atol=1e-15)
    g2 = ((-1.0, -1.0), (1.0, 1.0), (9, 11))
    for name in ("circle", "box"):
        mk = {"circle": lambda s: s.circle((0.1, -0.2), 0.4),
              "box": lambda s: s.box((-0.3, -0.5), (0.2, 0.6))}[name]
        a = T.sample(mk(tshapes), T.Grid(*g2), dtype=torch.float64, device="cpu").values
        b = J.sample(mk(jshapes), J.Grid(*g2), dtype=jnp.float64).values
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-14)
    xs_t = T.Grid(*g2).coords(torch.float64, device="cpu")
    xs_j = J.Grid(*g2).coords(jnp.float64)
    for a, b in zip(tshapes.rigid_rotation_velocity((0.2, 0.1), 2.0)(xs_t, 0.0),
                    jshapes.rigid_rotation_velocity((0.2, 0.1), 2.0)(xs_j, 0.0)):
        np.testing.assert_allclose(_np(torch.broadcast_to(a, (9, 11))),
                                   np.broadcast_to(np.asarray(b), (9, 11)), atol=1e-15)


def test_meshfield_protocol():
    g = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (5, 6, 7))
    f = T.MeshField(torch.zeros(5, 6, 7, dtype=torch.float64), g)
    assert not f.has_bcs() and not f.is_vector
    with pytest.raises(ValueError, match="no boundary conditions"):
        f.pad(1)
    f2 = f.with_bcs(T.Symmetry())
    with pytest.raises(ValueError, match="already has"):
        f2.with_bcs(T.Periodic())
    assert f2.with_bcs(T.Periodic(), replace=True).bcs[0][0] == T.Periodic()
    assert f2.pad(2).shape == (9, 10, 11)
    v = T.MeshField(torch.zeros(3, 5, 6, 7, dtype=torch.float64), g, T.Periodic())
    assert v.is_vector and v.pad(1).shape == (3, 7, 8, 9)
    assert f2.with_values(torch.ones(5, 6, 7)).values.sum() == 210


def _diffs(rng, n):
    """Six backward differences with exact ties, flat stencils and large jumps."""
    dm = rng.standard_normal((6, n))
    dm[:, : n // 8] = 0.0  # flat: all v_i = 0
    dm[:, n // 8: n // 4] = 1.5  # uniform slope
    dm[:, n // 4: n // 4 + 8] *= 1e3
    return dm


def test_weno5_upwind_matches_jax_with_ties():
    rng = np.random.default_rng(11)
    n = 512
    dm = _diffs(rng, n)
    u = rng.standard_normal(n)
    u[::5] = 0.0  # u == 0 takes the plus branch and multiplies by 0
    u[1::7] = -0.0
    got = tst.weno5_upwind([torch.from_numpy(d) for d in dm], torch.from_numpy(u))
    ref = jst.weno5_upwind([jnp.asarray(d) for d in dm], jnp.asarray(u))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-12)
    assert np.all(_np(got)[u == 0.0] == 0.0)
    # the selected branch at u > 0 is weno5-, at u < 0 weno5+: check one of each
    v = rng.standard_normal((7, 16))
    p = torch.from_numpy(v)
    pd = tst.weno5_pair_diffs(p, 0, 0.1, 3, (1, 16))
    jd = jst.weno5_pair_diffs(jnp.asarray(v), 0, 0.1, 3, (1, 16))
    for a, b in zip(pd, jd):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-12)


def test_weno5_upwind_matches_jax_float32():
    rng = np.random.default_rng(12)
    dm = _diffs(rng, 256).astype(np.float32)
    u = rng.standard_normal(256).astype(np.float32)
    u[::3] = 0.0
    got = tst.weno5_upwind([torch.from_numpy(d) for d in dm], torch.from_numpy(u))
    ref = jst.weno5_upwind([jnp.asarray(d) for d in dm], jnp.asarray(u))
    assert got.dtype == torch.float32
    scale = max(float(np.abs(np.asarray(ref)).max()), 1.0)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0, atol=1e-6 * scale)


def test_stencil_first_derivatives_match_jax():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((8, 9, 10))
    shape = (6, 7, 8)
    for op in ("d0", "dp", "dm"):
        for ax in range(3):
            a = getattr(tst, op)(torch.from_numpy(v), ax, 0.3, 1, shape)
            b = getattr(jst, op)(jnp.asarray(v), ax, 0.3, 1, shape)
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("bc", ["periodic", "none"])
def test_volume_perimeter_match_jax(bc):
    args = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (14, 16, 18))
    tb = T.Periodic() if bc == "periodic" else None
    jb = J.Periodic() if bc == "periodic" else None
    tphi = T.sample(tshapes.sphere((0.5, 0.45, 0.5), 0.3), T.Grid(*args), tb,
                    dtype=torch.float64, device="cpu")
    jphi = J.sample(jshapes.sphere((0.5, 0.45, 0.5), 0.3), J.Grid(*args), jb,
                    dtype=jnp.float64)
    assert abs(float(tgeo.volume(tphi)) - float(jgeo.volume(jphi))) < 1e-12
    assert abs(float(tgeo.perimeter(tphi)) - float(jgeo.perimeter(jphi))) < 1e-12
    x = torch.linspace(-0.3, 0.3, 41, dtype=torch.float64)
    for name in ("smooth_heaviside", "smooth_delta"):
        a = getattr(tgeo, name)(x, 0.1)
        b = getattr(jgeo, name)(jnp.asarray(_np(x)), 0.1)
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-14)


def test_checkpoint_jax_saves_port_loads(tmp_path):
    rng = np.random.default_rng(21)
    grid = J.Grid((0.0, -1.0, 0.0), (1.0, 1.0, 2.0), (6, 7, 8))
    bcs = [(J.Symmetry(), J.Extrapolation(2)), J.Periodic(), J.Neumann()]
    vals = rng.standard_normal(grid.shape)
    vel = rng.standard_normal((3, *grid.shape))
    path = jckpt.save_checkpoint(tmp_path / "j.npz", J.MeshField(jnp.asarray(vals), grid, bcs),
                                 t=0.25, extra_arrays={"vel": vel}, metadata={"steps": 3})
    phi, t, extra, meta = tckpt.load_checkpoint(path, device="cpu")
    assert isinstance(phi.values, torch.Tensor) and phi.values.dtype == torch.float64
    np.testing.assert_array_equal(_np(phi.values), vals)
    np.testing.assert_array_equal(extra["vel"], vel)
    assert t == 0.25 and meta == {"steps": 3}
    assert phi.grid == T.Grid(grid.lo, grid.hi, grid.shape)
    assert phi.bcs == T.normalize_bcs(
        [(T.Symmetry(), T.Extrapolation(2)), T.Periodic(), T.Neumann()], 3)


def test_checkpoint_port_saves_jax_loads(tmp_path):
    rng = np.random.default_rng(22)
    grid = T.Grid((0.0, 0.0, 0.0), (1.0, 2.0, 3.0), (5, 6, 7))
    vals = rng.standard_normal(grid.shape).astype(np.float32)
    phi = tckpt.field_from_numpy(vals, grid, [T.Periodic(), T.Symmetry(), T.Extrapolation(1)],
                                 device="cpu")
    assert phi.values.dtype == torch.float32
    path = tckpt.save_checkpoint(tmp_path / "t.npz", phi, t=1.5, metadata={"k": "v"})
    jphi, t, extra, meta = jckpt.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(jphi.values), vals)
    assert jphi.bcs == J.normalize_bcs([J.Periodic(), J.Symmetry(), J.Extrapolation(1)], 3)
    assert (t, extra, meta) == (1.5, {}, {"k": "v"})
    # and back again: the port reads its own file bit for bit, into float64 if asked
    phi2, _, _, _ = tckpt.load_checkpoint(path, device="cpu")
    np.testing.assert_array_equal(_np(phi2.values), vals)
    f64 = tckpt.field_from_numpy(vals, grid, T.Periodic(), dtype=torch.float64, device="cpu")
    assert f64.values.dtype == torch.float64
