"""``reinitialize`` (PDE reinitialization with the subcell fix) against the
JAX package's, on the CPU in float64: a 2D star and a 3D sphere whose
gradient norm is not 1, with and without the subcell fix and a band."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.reinit import eikonal as jreinit
from lsm_tpu_torch.reinit import eikonal as treinit


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy()


def _fields(case):
    """A level set that is not a signed distance, for both packages: a star
    scaled by ``1 + x^2`` (40^2) or a sphere scaled by ``0.5 + |x|^2``
    (20^3), on [-1, 1]^d."""
    if case == "star2d":
        shape = (40, 40)
        grid = J.Grid((-1.0, -1.0), (1.0, 1.0), shape)
        X, Y = np.meshgrid(*(np.linspace(-1.0, 1.0, n) for n in shape), indexing="ij")
        r = np.sqrt(X ** 2 + Y ** 2)
        theta = np.arctan2(Y, X) - np.pi / 2
        vals = (r - (0.5 + 0.1 * np.cos(5 * theta))) * (1.0 + X ** 2)
        bc = (J.LinearExtrapolation(), T.LinearExtrapolation())
    else:
        shape = (20, 20, 20)
        grid = J.Grid((-1.0,) * 3, (1.0,) * 3, shape)
        X, Y, Z = np.meshgrid(*(np.linspace(-1.0, 1.0, n) for n in shape), indexing="ij")
        rr = X ** 2 + Y ** 2 + Z ** 2
        vals = (np.sqrt(rr) - 0.55) * (0.5 + rr)
        bc = (J.Extrapolation(2), T.Extrapolation(2))
    jphi = J.MeshField(jnp.asarray(vals), grid, bc[0])
    tphi = T.MeshField(torch.from_numpy(vals), T.Grid(grid.lo, grid.hi, grid.shape), bc[1])
    return jphi, tphi


@pytest.mark.parametrize("band", [False, True], ids=["full", "band5h"])
@pytest.mark.parametrize("subcell", [True, False], ids=["subcell", "plain"])
@pytest.mark.parametrize("case", ["star2d", "sphere3d"])
def test_reinitialize_matches_jax(case, subcell, band):
    jphi, tphi = _fields(case)
    bw = 5.0 * jphi.grid.min_spacing if band else None
    want = np.asarray(jreinit.reinitialize(jphi, subcell=subcell, band_width=bw).values)
    out = T.reinitialize(tphi, subcell=subcell, band_width=bw)
    assert isinstance(out, T.MeshField) and out.values.dtype == torch.float64
    np.testing.assert_allclose(_np(out.values), want, rtol=0, atol=1e-10)
    # it did reinitialize: |grad phi| moved toward 1 near the interface
    h = jphi.grid.min_spacing
    near = np.abs(want) < 2 * h
    g0 = np.linalg.norm(np.gradient(np.asarray(jphi.values), h), axis=0)
    g1 = np.linalg.norm(np.gradient(_np(out.values), h), axis=0)
    assert np.abs(g1 - 1)[near].mean() < np.abs(g0 - 1)[near].mean()


def test_reinit_rhs_and_defaults_match_jax():
    jphi, tphi = _fields("star2d")
    s0 = np.asarray(jphi.values) / np.sqrt(np.asarray(jphi.values) ** 2 + 0.01)
    np.testing.assert_allclose(_np(treinit.reinit_rhs(tphi, torch.from_numpy(s0))),
                               np.asarray(jreinit.reinit_rhs(jphi, jnp.asarray(s0))),
                               rtol=0, atol=1e-12)
    # a field without BCs gets linear extrapolation; a few explicit iterations
    bare_j = J.MeshField(jphi.values, jphi.grid)
    bare_t = T.MeshField(tphi.values, tphi.grid)
    want = np.asarray(jreinit.reinitialize(bare_j, iters=7, cfl=0.3).values)
    np.testing.assert_allclose(_np(T.reinitialize(bare_t, iters=7, cfl=0.3).values), want,
                               rtol=0, atol=1e-12)


def test_reinitialize_keeps_a_band_field():
    """On a NarrowBandField the update lands on the compute band (JAX's
    ``with_values``), and the result stays a band field."""
    jphi, tphi = _fields("sphere3d")
    jnb = J.NarrowBandField.from_field(jphi)
    tnb = T.NarrowBandField.from_field(tphi)
    want = jreinit.reinitialize(jnb, iters=6)
    out = T.reinitialize(tnb, iters=6)
    assert isinstance(out, T.NarrowBandField)
    np.testing.assert_allclose(_np(out.values), np.asarray(want.values), rtol=0, atol=1e-12)
