"""The port's in-process mesh (``lsm_tpu_torch.parallel``) on the CPU: the
mesh and its collectives (``spmd``: lockstep, errors, timeouts, grad mode,
the launch counters), the domain decomposition (``sharding``), the halo pad
against the JAX package's on its 8-device CPU mesh, the shell writer K9's
plain version against JAX's ``write_shell_blocks`` (interpret mode), K2's
single-axis entry, and the sharded ghost refresh against the single-device
refresh, bit for bit."""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.core.bc import normalize_bcs as jnormalize
from lsm_tpu.parallel import fused_evolve as jfe
from lsm_tpu.parallel import halo as jhalo
from lsm_tpu.parallel import sharding as jsharding
from lsm_tpu_torch.core.bc import pad_ghost
from lsm_tpu_torch.ops import _launches
from lsm_tpu_torch.ops import weno_v2 as v2
from lsm_tpu_torch.parallel import fused_evolve as fe
from lsm_tpu_torch.parallel import halo, sharding, spmd
from lsm_tpu_torch.parallel import (HaloField, ShardedField, constrain, domain_spec,
                                    halo_pad_axis, make_mesh, shard_field, unshard)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_f64():
    prev, dtype = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_num_threads(prev)
    torch.set_default_dtype(dtype)


def _cpu_mesh(shape, names=None):
    return make_mesh(devices=["cpu"] * int(np.prod(shape)), mesh_shape=shape,
                     axis_names=names or "xyz"[:len(shape)])


def _no_shard_threads():
    return not any(th.name.startswith("lsm-shard") and th.is_alive()
                   for th in threading.enumerate())


# -- the mesh -------------------------------------------------------------------------


def test_make_mesh_shapes_and_names_follow_jax():
    m = make_mesh(devices=["cpu"] * 8)
    assert dict(m.shape) == {"x": 2, "y": 4} == dict(jsharding.make_mesh(8).shape)
    assert sharding._factorize(12, 3) == jsharding._factorize(12, 3)
    m = make_mesh(devices=["cpu"] * 8, mesh_shape=(4, 2), axis_names=("x", "y"))
    assert m.axis_names == ("x", "y") and m.devices.shape == (4, 2) and m.size == 8
    assert all(d == torch.device("cpu") for d in m.devices.flat)  # a device may repeat
    assert make_mesh(n_devices=3, devices=["cpu"] * 8).devices.shape == (1, 3)
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(devices=["cpu"] * 8, mesh_shape=(3, 2))
    assert domain_spec(m, 3) == ("x", "y", None)
    assert domain_spec(m, 2, vector=True) == (None, "x", "y")
    assert domain_spec(_cpu_mesh((2, 2, 2)), 2) == ("x", "y")


def test_make_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_shard_and_unshard_round_trip_fields_bands_and_gradients():
    mesh = _cpu_mesh((4, 2))
    grid = T.Grid((-1.0, -1.0), (1.0, 1.0), (16, 8))
    rng = np.random.default_rng(0)
    v = torch.tensor(rng.standard_normal(grid.shape), requires_grad=True)
    sf = shard_field(T.MeshField(v, grid, T.Extrapolation(1)), mesh)
    assert isinstance(sf, ShardedField) and sf.blocks.shape == (4, 2)
    assert tuple(sf.blocks[1, 1].shape) == (4, 4)
    assert torch.equal(sf.blocks[1, 1], v.detach()[4:8, 4:8])
    back = unshard(sf)
    assert torch.equal(back.values, v.detach()) and back.bcs == sf.bcs
    (g,) = torch.autograd.grad((back.values ** 3).sum(), v)
    assert torch.allclose(g, 3 * v.detach() ** 2)
    vec = T.sample(lambda x, y: (x + 0 * y, y + 0 * x), grid, vector=True, device="cpu")
    svec = shard_field(vec, mesh)
    assert tuple(svec.blocks[0, 1].shape) == (2, 4, 4) and svec.is_vector
    assert torch.equal(unshard(svec).values, vec.values)
    phi = T.sample(lambda x, y: torch.sqrt(x ** 2 + y ** 2) - 0.5, grid, T.Extrapolation(2),
                   device="cpu")
    nb = T.NarrowBandField.from_field(phi)
    snb = shard_field(nb, mesh)
    nb2 = unshard(snb)
    assert isinstance(nb2, T.NarrowBandField) and snb.is_band
    assert torch.equal(nb2.mask, nb.mask) and torch.equal(nb2.compute_mask, nb.compute_mask)
    # a mesh axis the grid is not split over holds replicas
    rep = constrain(v.detach(), _cpu_mesh((2, 2, 2)), 2)
    assert torch.equal(rep[1, 0, 0], rep[1, 0, 1])
    with pytest.raises(ValueError, match="does not split"):
        constrain(v.detach(), _cpu_mesh((3, 1)), 2)


def test_the_plain_engine_refuses_a_sharded_field():
    mesh = _cpu_mesh((2, 2))
    grid = T.Grid((0.0, 0.0), (1.0, 1.0), (8, 8))
    phi = T.sample(lambda x, y: x + y, grid, T.Periodic(), device="cpu")
    sf = shard_field(phi, mesh)
    term = T.AdvectionTerm(lambda xs, t: (1.0 + 0 * xs[0], 0 * xs[1]))
    with pytest.raises(TypeError, match="explicit sharded paths"):
        T.LevelSetEquation(terms=term, ic=sf)
    with pytest.raises(TypeError, match="explicit sharded paths"):
        T.rollout(T.RK3(), term, sf, 0.0, 0.01, 1)
    with pytest.raises(TypeError, match="explicit sharded paths"):
        T.RK3().advance((term,), sf, 0.0, 0.01)


# -- the collectives -----------------------------------------------------------------


def test_collectives_ring_shift_min_index_and_grad_mode():
    mesh = _cpu_mesh((2, 4))

    def local(c):
        i, j = spmd.axis_index("x"), spmd.axis_index("y")
        assert (i, j) == c
        mine = torch.tensor([10.0 * i + j], requires_grad=True)
        got = spmd.ppermute(mine * 2, "y", halo._ring_perm(4, +1))  # from (i, j - 1)
        low = spmd.pmin(torch.tensor([float(j - i)]), "y")
        both = spmd.pmin(torch.tensor([float(j - i)]), ("x", "y"))
        return mine, got, float(low), float(both), torch.is_grad_enabled()

    out = spmd.run(mesh, local)
    for (i, j) in mesh.coords():
        mine, got, low, both, grad = out[i, j]
        assert float(got.detach()) == 2 * (10.0 * i + (j - 1) % 4)
        assert low == -i and both == -1.0 and grad
        # the graph spans the shards: the slab came from the left neighbour
        (g,) = torch.autograd.grad(got.sum(), out[i, (j - 1) % 4][0])
        assert float(g) == 2.0
    with torch.no_grad():
        assert not any(r for r in spmd.run(mesh, lambda c: torch.is_grad_enabled()).flat)
    assert _no_shard_threads()


def test_a_shard_that_raises_raises_in_the_caller_without_hanging():
    mesh = _cpu_mesh((2, 4))

    def local(c):
        if c == (1, 2):
            raise ValueError("shard (1, 2) failed")
        return spmd.pmin(torch.tensor(1.0), ("x", "y"))

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match=r"shard \(1, 2\) failed") as info:
        spmd.run(mesh, local, timeout=30.0)
    assert time.perf_counter() - t0 < 10.0
    assert any("(1, 2)" in note for note in info.value.__notes__)
    assert _no_shard_threads()


def test_a_shard_that_never_arrives_times_out():
    mesh = _cpu_mesh((2, 2))

    def local(c):
        if c == (0, 0):
            time.sleep(1.0)  # misses the collective's timeout
        return spmd.pmin(torch.tensor(1.0), "x")

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        spmd.run(mesh, local, timeout=0.3)
    assert time.perf_counter() - t0 < 10.0
    deadline = time.perf_counter() + 10.0
    while not _no_shard_threads() and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert _no_shard_threads()


def test_shards_that_disagree_on_the_collective_raise():
    mesh = _cpu_mesh((1, 2))

    def local(c):
        if c == (0, 0):
            return spmd.pmin(torch.tensor(1.0), "y")
        return spmd.ppermute(torch.tensor(1.0), "y", halo._ring_perm(2, 1))

    with pytest.raises((RuntimeError, TimeoutError)):
        spmd.run(mesh, local, timeout=5.0)
    assert _no_shard_threads()


def test_launch_counters_stay_exact_across_threads():
    def fn():
        pass

    fn.launches, fn.kinds_launches = 0, 0
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _launches.bump(fn, launches=1, kinds_launches=True)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(prev)
    assert fn.launches == fn.kinds_launches == 16 * 2000


# -- the halo pad against JAX's --------------------------------------------------------


@pytest.mark.parametrize("bc", ["periodic", "extrap0", "extrap2", "symmetry"])
def test_halo_pad_matches_jax(bc):
    jbc = {"periodic": J.Periodic(), "extrap0": J.Extrapolation(0),
           "extrap2": J.Extrapolation(2), "symmetry": J.Symmetry()}[bc]
    tbc = {"periodic": T.Periodic(), "extrap0": T.Extrapolation(0),
           "extrap2": T.Extrapolation(2), "symmetry": T.Symmetry()}[bc]
    jmesh = jsharding.make_mesh(8, mesh_shape=(4, 2), axis_names=("x", "y"))
    rng = np.random.default_rng(3)
    v = rng.standard_normal((32, 16))
    jb = jnormalize(jbc, 2)

    def jlocal(vloc):
        out = jhalo.halo_pad_axis(vloc, 0, "x", 4, jb[0], 3)
        return jhalo.halo_pad_axis(out, 1, "y", 2, jb[1], 3)

    got = np.asarray(jax.jit(shard_map(jlocal, mesh=jmesh, in_specs=P("x", "y"),
                                       out_specs=P("x", "y"), check_vma=False))(jnp.asarray(v)))
    mesh = _cpu_mesh((4, 2))
    tb = T.normalize_bcs(tbc, 2)
    blocks = constrain(torch.tensor(v), mesh, 2)

    def tlocal(c):
        out = halo_pad_axis(blocks[c], 0, "x", 4, tb[0], 3)
        return halo_pad_axis(out, 1, "y", 2, tb[1], 3)

    out = spmd.run(mesh, tlocal)
    b0, b1 = 8 + 6, 8 + 6
    for i, j in mesh.coords():
        want = got[i * b0:(i + 1) * b0, j * b1:(j + 1) * b1]
        np.testing.assert_allclose(out[i, j].numpy(), want, rtol=0, atol=1e-12)
        # and HaloField.pad takes the same route
        hf = HaloField(blocks[i, j], T.Grid((0.0, 0.0), (1.0, 1.0), (32, 16)), tb, ("x", "y"),
                       (4, 2))
        assert hf.shape == (8, 8)


def test_halo_field_pad_on_a_three_axis_mesh_is_the_global_pad():
    """(2, 2, 2): every axis split, mixed BCs, bit for bit against the
    single-device ``pad_ghost`` (corners included), scalar and vector."""
    mesh = _cpu_mesh((2, 2, 2))
    grid = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (8, 12, 10))
    bcs = T.normalize_bcs([(T.Symmetry(), T.Extrapolation(1)), T.Periodic(),
                           (T.Extrapolation(2), T.Symmetry())], 3)
    rng = np.random.default_rng(4)
    v = torch.tensor(rng.standard_normal(grid.shape))
    vec = torch.tensor(rng.standard_normal((3, *grid.shape)))
    ref, vref = pad_ghost(v, bcs, 3), pad_ghost(vec, ((None, None),) + bcs, 3, axes=(1, 2, 3))
    sv, svec = constrain(v, mesh, 3), constrain(vec, mesh, 3, vector=True)
    axes, sizes = halo.mesh_layout(mesh, 3)

    def local(c):
        return (HaloField(sv[c], grid, bcs, axes, sizes).pad(3),
                HaloField(svec[c], grid, bcs, axes, sizes).pad(3))

    out = spmd.run(mesh, local)
    for c in mesh.coords():
        sl = tuple(slice(k * n // 2, k * n // 2 + n // 2 + 6) for k, n in zip(c, grid.shape))
        assert torch.equal(out[c][0], ref[sl])
        assert torch.equal(out[c][1], vref[(slice(None),) + sl])


# -- K9 and K2's single-axis entry ----------------------------------------------------


def test_shell_writer_plain_matches_jax_block_by_block():
    """JAX's layout has an 8-column pad on axis 1 and no lane ghosts, the
    port's 3 ghosts everywhere: each block must land where its layout puts
    it, and nothing else may move."""
    n0, n1, n2 = 6, 8, 16
    G, G1 = 3, 8
    rng = np.random.default_rng(5)
    jP = rng.standard_normal((n0 + 2 * G, n1 + 2 * G1, n2))
    l0, r0 = rng.standard_normal((2, G, n1, n2))
    l1, r1 = rng.standard_normal((2, n0 + 2 * G, G, n2))
    jout = np.asarray(jfe.write_shell_blocks(jnp.asarray(jP), *(jnp.asarray(b) for b in
                                                                (l0, r0, l1, r1)),
                                             (n0, n1, n2), interpret=True))
    tP = torch.tensor(rng.standard_normal((n0 + 2 * G, n1 + 2 * G, n2 + 2 * G)))
    before = tP.clone()
    tout = fe.write_shell_blocks(tP, *(torch.tensor(b) for b in (l0, r0, l1, r1)),
                                 (n0, n1, n2))
    assert tout is tP  # in place
    lanes = slice(G, G + n2)
    pairs = [((slice(0, G), slice(G1, G1 + n1)), (slice(0, G), slice(G, G + n1))),
             ((slice(G + n0, None), slice(G1, G1 + n1)), (slice(G + n0, None), slice(G, G + n1))),
             ((slice(None), slice(G1 - G, G1)), (slice(None), slice(0, G))),
             ((slice(None), slice(G1 + n1, G1 + n1 + G)), (slice(None), slice(G + n1, None)))]
    written = torch.zeros_like(tP, dtype=torch.bool)
    for (js0, js1), (ts0, ts1) in pairs:
        np.testing.assert_array_equal(tout[ts0, ts1, lanes].numpy(), jout[js0, js1, :])
        written[ts0, ts1, lanes] = True
    assert torch.equal(tout[~written], before[~written])
    np.testing.assert_array_equal(jout[G:G + n0, G1:G1 + n1], jP[G:G + n0, G1:G1 + n1])


def test_shell_writer_takes_any_subset_and_checks_its_blocks():
    shape = (4, 5, 6)
    P = torch.zeros(v2.padded_shape(shape), dtype=torch.float32)
    l0 = torch.ones(3, 5, 6, dtype=torch.float32)
    fe.write_shell_blocks(P, None, l0, None, None, shape)
    assert float(P.sum()) == l0.numel() and bool((P[7:, 3:8, 3:9] == 1).all())
    with pytest.raises(ValueError, match="shape"):
        fe.write_shell_blocks(P, torch.ones(3, 5, 7), None, None, None, shape)
    with pytest.raises(ValueError, match="float64"):
        fe.write_shell_blocks(P, l0.double(), None, None, None, shape)


def test_single_axis_refresh_phases_compose_to_the_whole_refresh():
    shape = (6, 7, 9)
    bcs = T.normalize_bcs([(T.Symmetry(), T.Extrapolation(3)), T.Periodic(),
                           (T.Extrapolation(0), T.Symmetry())], 3)
    rng = np.random.default_rng(6)
    P = torch.tensor(rng.standard_normal(v2.padded_shape(shape)))
    ref = v2.refresh_ghosts_plain(P.clone(), bcs, shape)
    got = P.clone()
    for ax in range(3):
        one = got.clone()
        assert v2.refresh_axis_fast(got, bcs, shape, ax) is got
        assert torch.equal(got, v2.refresh_axis_plain(one, bcs, shape, ax))
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="axis 3"):
        v2.refresh_axis_fast(got, bcs, shape, 3)


# -- the sharded refresh ---------------------------------------------------------------


BC_CASES = {
    "periodic": T.Periodic(), "symmetry": T.Symmetry(), "extrap0": T.Extrapolation(0),
    "extrap1": T.Extrapolation(1), "extrap2": T.Extrapolation(2),
    "mixed": [(T.Symmetry(), T.Extrapolation(1)), T.Periodic(),
              (T.Extrapolation(2), T.Symmetry())],
}


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (4, 1), (1, 4), (1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bc", list(BC_CASES))
def test_sharded_refresh_is_the_single_device_refresh(mesh_shape, bc):
    mesh = _cpu_mesh(mesh_shape)
    grid = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (16, 24, 10))
    bcs = T.normalize_bcs(BC_CASES[bc], 3)
    rng = np.random.default_rng(7)
    v = torch.tensor(rng.standard_normal(grid.shape))
    ref = v2.refresh_ghosts_plain(v2.pack_padded(v, bcs), bcs, grid.shape)
    layout = fe.ShardLayout(mesh, grid)
    sv = constrain(v, mesh, 3)
    bufs = []
    for c in layout.coords:  # stale shells everywhere
        b = torch.full(v2.padded_shape(layout.local_shape), 1e9, dtype=v.dtype)
        v2.unpack_padded(b, layout.local_shape).copy_(sv[c])
        bufs.append(b)
    fe.refresh_ghosts_sharded(bufs, bcs, layout)
    m0, m1, _ = layout.local_shape
    for b, (i, j) in zip(bufs, layout.pos):
        assert torch.equal(b, ref[i * m0:i * m0 + m0 + 6, j * m1:j * m1 + m1 + 6])
    # its transpose is the adjoint: <R x, y> = <x, R^T y> on random data
    x = [torch.tensor(rng.standard_normal(b.shape)) for b in bufs]
    y = [torch.tensor(rng.standard_normal(b.shape)) for b in bufs]
    rx = fe.refresh_ghosts_sharded([a.clone() for a in x], bcs, layout)
    rty = fe.refresh_sharded_transpose(y, bcs, layout)
    lhs = sum(float((a * b).sum()) for a, b in zip(rx, y))
    rhs = sum(float((a * b).sum()) for a, b in zip(x, rty))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
