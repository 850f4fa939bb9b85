"""The port's sharded general path on the CPU in float64, against the JAX
package's on its 8-device CPU mesh: the sharded band mask, the dense and
narrow-band adaptive evolution (``make_sharded_evolve``: each shard's loop
in its own thread, the CFL bound ``pmin``-reduced), and the sharded step
(``make_sharded_step``, 2D and 3D, dense and band). A callable coefficient,
which the general path cannot evaluate per shard, raises naming its term."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.core.narrowband import NarrowBandField as JNarrowBandField
from lsm_tpu.parallel import make_mesh as jmake_mesh
from lsm_tpu.parallel import make_sharded_evolve as jmake_sharded_evolve
from lsm_tpu.parallel import make_sharded_step as jmake_sharded_step
from lsm_tpu.parallel import shard_field as jshard_field
from lsm_tpu.parallel import sharded_band_mask as jsharded_band_mask
from lsm_tpu_torch.core.narrowband import band_mask_from_values
from lsm_tpu_torch.ops import weno_general as wg
from lsm_tpu_torch.parallel import (constrain, make_mesh, make_sharded_evolve,
                                    make_sharded_step, shard_field, sharded_band_mask, spmd,
                                    unshard)
from lsm_tpu_torch.utils.checkpoint import field_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread_f64():
    prev, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(prev)
    torch.set_default_dtype(dtype)


def _meshes():
    jm = jmake_mesh(8, mesh_shape=(4, 2), axis_names=("x", "y"))
    tm = make_mesh(devices=["cpu"] * 8, mesh_shape=(4, 2), axis_names=("x", "y"))
    return jm, tm


GRID2 = ((-1.0, -1.0), (1.0, 1.0), (64, 32))
TF = 0.25  # 24 adaptive RK3 steps (dense), 14 (band)


def _disk(X, Y, sqrt):
    return sqrt((X - 0.3) ** 2 + Y ** 2) - 0.35


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sharded runs on its (4, 2) mesh, each once: the dense and band
    evolves (RK3 to t = TF, >= 20 steps), the band mask, the 2D steps on
    three BCs, the 2D band step."""
    jm, _ = _meshes()
    grid = J.Grid(*GRID2)
    phi = J.sample(lambda X, Y: _disk(X, Y, jnp.sqrt), grid, J.Extrapolation(2))
    vel = J.sample(lambda X, Y: (-Y, X), grid, vector=True)
    term = J.AdvectionTerm(vel)
    out = {"phi": np.array(phi.values), "vel": np.array(vel.values)}
    ev = jmake_sharded_evolve(J.RK3(), jm, grid)
    o, t, n = ev((term,), jshard_field(phi, jm), 0.0, TF)
    out["dense"] = (np.array(o.values), float(t), int(n))
    nb = JNarrowBandField.from_field(phi)
    out["mask0"] = np.array(nb.mask)
    out["band_mask"] = np.array(jax.jit(shard_map(
        lambda v, m: jsharded_band_mask(v, m, 3, ("x", "y"), (4, 2)), mesh=jm,
        in_specs=(P("x", "y"), P("x", "y")), out_specs=P("x", "y"),
        check_vma=False))(nb.values, nb.mask))
    evb = jmake_sharded_evolve(J.RK3(), jm, grid, is_band=True, nlayers=3)
    o, t, n = evb((term,), jshard_field(nb, jm), 0.0, TF)
    out["band"] = (np.array(o.values), np.array(o.mask), float(t), int(n))
    step = jmake_sharded_step(J.RK3(), jm, grid)
    dt = 0.3 * grid.min_spacing
    out["band_step"] = np.array(step((term,), jshard_field(nb, jm), 0.0, dt).values)
    for name, bc in (("periodic", J.Periodic()), ("extrap2", J.Extrapolation(2)),
                     ("symmetry", J.Symmetry())):
        p = J.sample(lambda X, Y: jnp.sqrt(X ** 2 + Y ** 2) - 0.5, grid, bc)
        out[f"step_{name}"] = (np.array(p.values), np.array(step(
            (J.AdvectionTerm(jshard_field(vel, jm)),), jshard_field(p, jm), 0.0,
            0.4 * grid.min_spacing).values))
    return out


def _tfields(jr, bc=None):
    grid = T.Grid(*GRID2)
    phi = field_from_numpy(jr["phi"], grid, bc or T.Extrapolation(2), device="cpu")
    vel = field_from_numpy(jr["vel"], grid, device="cpu")
    return grid, phi, T.AdvectionTerm(vel)


def test_sharded_band_mask_matches_jax(jax_runs):
    grid, phi, _ = _tfields(jax_runs)
    _, tm = _meshes()
    mask0 = torch.from_numpy(jax_runs["mask0"])
    assert torch.equal(mask0, band_mask_from_values(phi.values, 3))
    v, m = constrain(phi.values, tm, 2), constrain(mask0, tm, 2)
    got = spmd.run(tm, lambda c: sharded_band_mask(v[c], m[c], 3, ("x", "y"), (4, 2)))
    full = torch.cat([torch.cat(list(got[i]), dim=1) for i in range(4)], dim=0)
    np.testing.assert_array_equal(full.numpy(), jax_runs["band_mask"])
    assert torch.equal(full, band_mask_from_values(phi.values, 3, mask0))


def test_sharded_dense_evolve_matches_jax(jax_runs):
    grid, phi, term = _tfields(jax_runs)
    _, tm = _meshes()
    wg.weno_stage_2d.launches = 0
    out, t, n = make_sharded_evolve(T.RK3(), tm, grid)((term,), phi, 0.0, TF)
    want, jt, jn = jax_runs["dense"]
    assert n == jn >= 20 and abs(t - jt) <= 1e-12 * abs(jt)
    np.testing.assert_allclose(out.values.numpy(), want, rtol=0, atol=1e-12)
    # and the port's own single-device evolve, bit for bit
    ref, _, t_ref, n_ref = T.evolve(T.RK3(), (term,), phi, 0.0, TF)
    assert n == n_ref and t == t_ref and torch.equal(out.values, ref.values)
    assert wg.weno_stage_2d.launches == 0  # the CPU runs K11's plain version


def test_sharded_evolve_stops_at_max_steps(jax_runs):
    grid, phi, term = _tfields(jax_runs)
    _, tm = _meshes()
    out, t, n = make_sharded_evolve(T.RK3(), tm, grid, max_steps=5)((term,), phi, 0.0, TF)
    ref, _, t_ref, n_ref = T.evolve(T.RK3(), (term,), phi, 0.0, TF, max_steps=5)
    assert n == n_ref == 5 and t == t_ref < TF and torch.equal(out.values, ref.values)


def test_sharded_band_evolve_matches_jax(jax_runs):
    grid, phi, term = _tfields(jax_runs)
    _, tm = _meshes()
    nb = T.NarrowBandField.from_field(phi)
    ev = make_sharded_evolve(T.RK3(), tm, grid, is_band=True, nlayers=3)
    out, t, n = ev((term,), nb, 0.0, TF)
    want, wmask, jt, jn = jax_runs["band"]
    assert isinstance(out, T.NarrowBandField)
    assert n == jn >= 10 and abs(t - jt) <= 1e-12 * abs(jt)  # the band's bound: 14 steps
    np.testing.assert_array_equal(out.mask.numpy(), wmask)
    np.testing.assert_allclose(out.values.numpy(), want, rtol=0, atol=1e-12)
    # a dense field with is_band=True builds its band, sharded, first
    ev3 = make_sharded_evolve(T.RK3(), tm, grid, max_steps=3, is_band=True, nlayers=3)
    out2, _, _ = ev3((term,), phi, 0.0, TF)
    out3, _, _ = ev3((term,), nb, 0.0, TF)
    assert torch.equal(out2.mask, out3.mask) and torch.equal(out2.values, out3.values)


def test_sharded_band_step_matches_jax(jax_runs):
    grid, phi, term = _tfields(jax_runs)
    _, tm = _meshes()
    nb = T.NarrowBandField.from_field(phi)
    got = make_sharded_step(T.RK3(), tm, grid)((term,), nb, 0.0, 0.3 * grid.min_spacing)
    assert isinstance(got, T.NarrowBandField) and torch.equal(got.mask, nb.mask)
    np.testing.assert_allclose(got.values.numpy(), jax_runs["band_step"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("bc", ["periodic", "extrap2", "symmetry"])
def test_sharded_step_2d_matches_jax(jax_runs, bc):
    phi0, want = jax_runs[f"step_{bc}"]
    tbc = {"periodic": T.Periodic(), "extrap2": T.Extrapolation(2), "symmetry": T.Symmetry()}[bc]
    grid, _, _ = _tfields(jax_runs)
    phi = field_from_numpy(phi0, grid, tbc, device="cpu")
    _, tm = _meshes()
    vel = shard_field(field_from_numpy(jax_runs["vel"], grid, device="cpu"), tm)
    got = make_sharded_step(T.RK3(), tm, grid)((T.AdvectionTerm(vel),), phi, 0.0,
                                                0.4 * grid.min_spacing)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got.values.numpy() - want).max() <= 1e-11 * scale


@pytest.fixture(scope="module")
def jax_step_3d():
    """JAX's 3D sharded step on a (2, 2, 2) mesh: advection + normal motion
    + curvature, mixed BCs, RK3."""
    jm = jmake_mesh(8, mesh_shape=(2, 2, 2), axis_names=("x", "y", "z"))
    grid = J.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (12, 16, 10))
    bc = [(J.Symmetry(), J.Extrapolation(1)), J.Periodic(), (J.Extrapolation(2), J.Symmetry())]
    phi = J.sample(lambda X, Y, Z: jnp.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.6, grid, bc)
    vel = J.sample(lambda X, Y, Z: (-Y + 0 * Z, X + 0 * Z, 0.2 + 0 * X), grid, vector=True)
    speed = J.sample(lambda X, Y, Z: 0.2 + 0.1 * X + 0 * Y * Z, grid)
    terms = (J.AdvectionTerm(vel), J.NormalMotionTerm(speed), J.CurvatureTerm(-0.05))
    dt = 0.2 * grid.min_spacing ** 2
    out = jmake_sharded_step(J.RK3(), jm, grid)(terms, jshard_field(phi, jm), 0.0, dt)
    return (np.array(phi.values), np.array(vel.values), np.array(speed.values),
            np.array(out.values), dt)


def test_sharded_step_3d_multi_term_matches_jax(jax_step_3d):
    phi0, vel0, speed0, want, dt = jax_step_3d
    tm = make_mesh(devices=["cpu"] * 8, mesh_shape=(2, 2, 2), axis_names=("x", "y", "z"))
    grid = T.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (12, 16, 10))
    bc = [(T.Symmetry(), T.Extrapolation(1)), T.Periodic(), (T.Extrapolation(2), T.Symmetry())]
    phi = field_from_numpy(phi0, grid, bc, device="cpu")
    terms = (T.AdvectionTerm(field_from_numpy(vel0, grid, device="cpu")),
             T.NormalMotionTerm(field_from_numpy(speed0, grid, device="cpu")),
             T.CurvatureTerm(-0.05))
    wg.weno_stage_3d.launches = 0
    got = make_sharded_step(T.RK3(), tm, grid)(terms, phi, 0.0, dt)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got.values.numpy() - want).max() <= 1e-11 * scale
    ref, _ = T.RK3().advance(terms, phi, 0.0, dt)
    assert torch.equal(got.values, ref.values)
    # a ShardedField comes back sharded
    sgot = make_sharded_step(T.RK3(), tm, grid)(terms, shard_field(phi, tm), 0.0, dt)
    assert torch.equal(unshard(sgot).values, got.values)


def test_a_callable_coefficient_on_the_general_path_raises_naming_its_term():
    """JAX's sharded step evaluates a callable at the global coordinates
    beside shard-local values and fails to broadcast; the port says why."""
    _, tm = _meshes()
    grid = T.Grid(*GRID2)
    phi = T.sample(lambda X, Y: _disk(X, Y, torch.sqrt), grid, T.Extrapolation(2), device="cpu")
    terms = (T.CurvatureTerm(-0.05), T.AdvectionTerm(lambda xs, t: (-xs[1], xs[0])))
    with pytest.raises(ValueError, match=r"term 1 \(AdvectionTerm\).*callable"):
        make_sharded_step(T.RK3(), tm, grid)(terms, phi, 0.0, 0.01)
    with pytest.raises(ValueError, match=r"term 0 \(NormalMotionTerm\)"):
        make_sharded_evolve(T.RK3(), tm, grid)(
            (T.NormalMotionTerm(lambda xs, t: 0.1 + 0 * xs[0]),), phi, 0.0, 0.1)


def test_an_invalid_cfl_bound_raises_in_every_shard():
    _, tm = _meshes()
    grid = T.Grid(*GRID2)
    phi = T.sample(lambda X, Y: _disk(X, Y, torch.sqrt), grid, T.Extrapolation(2), device="cpu")
    vel = T.sample(lambda X, Y: (-Y, X), grid, vector=True, device="cpu")
    vel.values[0, 5, 5] = float("nan")
    with pytest.raises(ValueError, match="invalid time-step"):
        make_sharded_evolve(T.RK3(), tm, grid)((T.AdvectionTerm(vel),), phi, 0.0, 0.1)
