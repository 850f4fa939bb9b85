"""The port's implicit-domain quadrature against the JAX package on the CPU,
in float64: volume and surface forms in 2D and 3D (the cells, their nodes
and weights, and the integrals), ``cell_quadrature`` on one patch, a narrow
band's surface form and its refusal of volumes, and the lazy
``InterpolatedField`` (which JAX's quadrature cannot read), held against the
eager one.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
# the packages' ``geometry.quadrature`` names the function; these are the modules
jq = importlib.import_module("lsm_tpu.geometry.quadrature")
tq = importlib.import_module("lsm_tpu_torch.geometry.quadrature")


def _fields(shape, radius=0.6, seed=0):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1.0, 1.0, n) for n in shape]
    xs = np.meshgrid(*axes, indexing="ij")
    vals = np.sqrt(sum(x ** 2 for x in xs)) - radius + 1e-3 * rng.standard_normal(shape)
    lo, hi = (-1.0,) * len(shape), (1.0,) * len(shape)
    jphi = J.MeshField(jnp.asarray(vals), J.Grid(lo, hi, shape), J.Extrapolation(2))
    tphi = T.MeshField(torch.from_numpy(vals), T.Grid(lo, hi, shape), T.Extrapolation(2))
    return jphi, tphi


def _same_quads(got, want, tol=1e-12):
    assert got.keys() == want.keys() and len(got) > 0
    for cell in want:
        (gp, gw), (wp, ww) = got[cell], want[cell]
        assert gp.shape == wp.shape and gw.shape == ww.shape
        assert np.abs(gp - wp).max() <= tol and np.abs(gw - ww).max() <= tol * np.abs(ww).max()


@pytest.mark.parametrize("surface", [False, True], ids=["volume", "surface"])
@pytest.mark.parametrize("shape", [(24, 22), (11, 12, 10)], ids=["2d", "3d"])
def test_quadrature_matches_jax(shape, surface):
    jphi, tphi = _fields(shape)
    want = J.quadrature(jphi, surface=surface)
    got = T.quadrature(tphi, surface=surface)
    _same_quads(got, want)
    a, b = T.integrate(None, got), J.integrate(None, want)
    assert abs(a - b) <= 1e-12 * abs(b)
    f = lambda p: 1.0 + p[:, 0] ** 2
    assert abs(T.integrate(f, got) - J.integrate(f, want)) <= 1e-12 * abs(J.integrate(f, want))
    r, n = 0.6, len(shape)
    exact = ({2: 2 * np.pi * r, 3: 4 * np.pi * r ** 2} if surface
             else {2: np.pi * r ** 2, 3: 4 / 3 * np.pi * r ** 3})[n]
    assert abs(a - exact) <= 0.02 * exact  # the noisy grid's circle / sphere


@pytest.mark.parametrize("surface", [False, True], ids=["volume", "surface"])
def test_lazy_field_matches_the_eager_one(surface):
    """JAX reads ``cf.coeffs``, which a lazy field lacks; the port gathers the
    candidates' coefficients from either, equal to round-off."""
    _, tphi = _fields((11, 12, 10), seed=1)
    eager = T.quadrature(T.InterpolatedField(tphi, 3, lazy=False), surface=surface)
    lazy = T.quadrature(T.InterpolatedField(tphi, 3, lazy=True), surface=surface)
    _same_quads(lazy, eager)
    assert abs(T.integrate(None, lazy) - T.integrate(None, eager)) <= 1e-12 * abs(
        T.integrate(None, eager))


def test_cell_quadrature_and_orders():
    jphi, tphi = _fields((13, 13), seed=2)
    jcf, tcf = J.InterpolatedField(jphi, 3), T.InterpolatedField(tphi, 3)
    cells = sorted(T.quadrature(tphi, surface=True))
    cell = cells[len(cells) // 2]  # a cut cell
    c, lo, hi = tcf.make_interpolant(cell)
    for surface in (False, True):
        gp, gw = T.geometry.cell_quadrature(c.numpy(), lo.numpy(), hi.numpy(), 5, surface)
        jc, jlo, jhi = jcf.make_interpolant(cell)
        wp, ww = jq.cell_quadrature(np.asarray(jc), np.asarray(jlo), np.asarray(jhi), 5, surface)
        assert gp.shape == wp.shape and len(gw) and np.abs(gw - ww).max() <= 1e-12
    got = T.quadrature(tphi, interpolation_order=2, quadrature_order=3)
    _same_quads(got, J.quadrature(jphi, interpolation_order=2, quadrature_order=3))
    assert tq.quadrature is T.quadrature and tq.integrate is T.integrate


def test_narrow_band_surface_and_volume_refusal():
    jphi, tphi = _fields((20, 20), seed=3)
    jnb, tnb = J.NarrowBandField.from_field(jphi), T.NarrowBandField.from_field(tphi)
    _same_quads(T.quadrature(tnb, surface=True), J.quadrature(jnb, surface=True))
    with pytest.raises(ValueError, match="narrow band"):
        T.quadrature(tnb, surface=False)
