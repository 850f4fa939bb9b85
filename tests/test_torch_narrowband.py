"""The port's narrow-band field against the JAX package, on the CPU in
float64: the mask algebra (box and L1 dilation, cut cells, the band mask)
bit for bit, ``NarrowBandField``'s rules and updates, the CFL bound over the
active band, and band checkpoints across the two packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.core import narrowband as jnb
from lsm_tpu.models import shapes as jshapes
from lsm_tpu.utils import checkpoint as jck
from lsm_tpu_torch.core import narrowband as tnb
from lsm_tpu_torch.utils import checkpoint as tck

SHAPE = (20, 24, 28)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _random_mask(seed, shape=SHAPE, p=0.03):
    return np.random.default_rng(seed).random(shape) < p


def _sphere_pair(shape=SHAPE, center=(0.45, 0.5, 0.55), radius=0.3, bc="extrap2"):
    args = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape)
    jbc, tbc = {"extrap2": (J.Extrapolation(2), T.Extrapolation(2)),
                "symmetry": (J.Symmetry(), T.Symmetry())}[bc]
    jphi = J.sample(jshapes.sphere(center, radius), J.Grid(*args), jbc, dtype=jnp.float64)
    tphi = tck.field_from_numpy(np.array(jphi.values), T.Grid(*args), tbc, device="cpu")
    return jphi, tphi


@pytest.mark.parametrize("radius", [0, 1, 3, 6])
@pytest.mark.parametrize("kind", ["box", "l1"])
def test_dilations_match_jax(kind, radius):
    m = _random_mask(radius)
    jf, tf = {"box": (jnb.box_dilate, tnb.box_dilate), "l1": (jnb.l1_dilate, tnb.l1_dilate)}[kind]
    got = _np(tf(torch.from_numpy(m), radius))
    np.testing.assert_array_equal(got, np.asarray(jf(jnp.asarray(m), radius)))


@pytest.mark.parametrize("with_node_mask", [False, True])
def test_cut_cells_and_band_mask_match_jax(with_node_mask):
    jphi, tphi = _sphere_pair()
    v = np.asarray(jphi.values).copy()
    v[3, 4, 5] = 0.0  # a node exactly on the interface
    node = _random_mask(7, p=0.7) if with_node_mask else None
    jn = None if node is None else jnp.asarray(node)
    tn = None if node is None else torch.from_numpy(node)
    got = _np(tnb.cut_cell_mask(torch.from_numpy(v), tn))
    np.testing.assert_array_equal(got, np.asarray(jnb.cut_cell_mask(jnp.asarray(v), jn)))
    for nlayers in (3, 4):
        got = _np(tnb.band_mask_from_values(torch.from_numpy(v), nlayers, tn))
        want = np.asarray(jnb.band_mask_from_values(jnp.asarray(v), nlayers, jn))
        np.testing.assert_array_equal(got, want)


def test_narrowband_constructor_rules():
    _, tphi = _sphere_pair()
    with pytest.raises(ValueError, match="Periodic"):
        T.NarrowBandField(tphi.values, tphi.grid, T.Periodic())
    with pytest.raises(ValueError, match="nlayers"):
        T.NarrowBandField(tphi.values, tphi.grid, tphi.bcs, nlayers=2)
    nb = T.NarrowBandField.from_field(tphi, nlayers=4)
    assert nb.nlayers == 4 and nb.active_mask is nb.mask
    assert nb.mask.dtype == torch.bool and nb.compute_mask.dtype == torch.bool
    assert int(nb.active_count()) == int(nb.mask.sum()) > 0
    assert bool((nb.compute_mask | ~nb.mask).all())  # active within compute
    with pytest.raises(ValueError, match="already has"):
        nb.with_bcs(T.Symmetry())
    nb2 = nb.with_bcs(T.Symmetry(), replace=True)
    assert isinstance(nb2, T.NarrowBandField) and nb2.mask is nb.mask
    # a dense field has no band and re-tubes to itself
    assert tphi.active_mask is None and tphi.update_band() is tphi


def test_with_values_and_update_band_match_jax():
    jphi, tphi = _sphere_pair()
    jb, tb = jnb.NarrowBandField.from_field(jphi), T.NarrowBandField.from_field(tphi)
    np.testing.assert_array_equal(_np(tb.mask), np.asarray(jb.mask))
    np.testing.assert_array_equal(_np(tb.compute_mask), np.asarray(jb.compute_mask))
    new = np.random.default_rng(3).standard_normal(SHAPE)
    jw, tw = jb.with_values(jnp.asarray(new)), tb.with_values(torch.from_numpy(new))
    np.testing.assert_array_equal(_np(tw.values), np.asarray(jw.values))
    assert isinstance(tw, T.NarrowBandField) and tw.mask is tb.mask
    # move the interface by a cell and re-tube: the mask follows it
    _, shifted = _sphere_pair(center=(0.5, 0.5, 0.55))
    ju = jb.with_values(jnp.asarray(_np(shifted.values)), mask_update=False).update_band()
    tu = tb.with_values(shifted.values, mask_update=False).update_band()
    np.testing.assert_array_equal(_np(tu.mask), np.asarray(ju.mask))
    np.testing.assert_array_equal(_np(tu.compute_mask), np.asarray(ju.compute_mask))
    assert not torch.equal(tu.mask, tb.mask)


def test_masked_cfl_matches_jax_with_garbage_off_band():
    """Repair: the CFL bound reduces over the active band only; a velocity
    that is huge off the band must not shrink it."""
    jphi, tphi = _sphere_pair()
    jb, tb = jnb.NarrowBandField.from_field(jphi), T.NarrowBandField.from_field(tphi)
    vel = np.random.default_rng(5).standard_normal((3, *SHAPE))
    vel[:, ~np.asarray(jb.mask)] = 1e6
    jterm = J.AdvectionTerm(J.MeshField(jnp.asarray(vel), jphi.grid))
    tterm = T.AdvectionTerm(T.MeshField(torch.from_numpy(vel), tphi.grid))
    want = float(J.compute_cfl((jterm,), jb, 0.0))
    got = float(T.compute_cfl((tterm,), tb, 0.0))
    assert got == pytest.approx(want, rel=1e-14, abs=0)
    assert got > 1e-3  # the off-band 1e6 would give dt ~ 1e-8
    assert float(T.compute_cfl((tterm,), tphi, 0.0)) < 1e-6  # dense: every node counts


def _arr(x):
    return _np(x) if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_band_checkpoint_across_packages(writer, tmp_path):
    jphi, tphi = _sphere_pair(bc="symmetry")
    src = (jnb.NarrowBandField.from_field(jphi, nlayers=4) if writer == "jax"
           else T.NarrowBandField.from_field(tphi, nlayers=4))
    path = tmp_path / "band.npz"
    save, load = ((jck.save_checkpoint, lambda p: tck.load_checkpoint(p, device="cpu"))
                  if writer == "jax" else (tck.save_checkpoint, jck.load_checkpoint))
    save(path, src, t=0.25, metadata={"step": 3})
    phi, t, _, meta = load(path)
    assert type(phi).__name__ == "NarrowBandField" and phi.nlayers == 4
    assert t == 0.25 and meta == {"step": 3}
    np.testing.assert_array_equal(_arr(phi.values), np.asarray(jphi.values))
    np.testing.assert_array_equal(_arr(phi.mask), _arr(src.mask))
    np.testing.assert_array_equal(_arr(phi.compute_mask), _arr(src.compute_mask))
    assert [type(b).__name__ for pair in phi.bcs for b in pair] == ["Symmetry"] * 6


def test_narrowband_from_numpy():
    jphi, _ = _sphere_pair()
    jb = jnb.NarrowBandField.from_field(jphi)
    grid = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), SHAPE)
    nb = tck.narrowband_from_numpy(np.array(jb.values), np.array(jb.mask), grid,
                                   T.Extrapolation(2), jb.nlayers, device="cpu")
    assert isinstance(nb, T.NarrowBandField) and nb.values.device.type == "cpu"
    np.testing.assert_array_equal(_np(nb.values), np.asarray(jb.values))
    np.testing.assert_array_equal(_np(nb.compute_mask), np.asarray(jb.compute_mask))
    assert nb.mask.dtype == torch.bool
