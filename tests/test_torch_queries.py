"""The port's geometric queries and CSG (``gradient``, ``grad_norm``,
``normal``, ``hessian``, ``curvature``, ``union``, ``intersection``,
``complement``, ``difference``) against the JAX package's, on the CPU in
float64, in 2D and 3D."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.models import shapes as jshapes
from lsm_tpu_torch.models import shapes as tshapes

CASES = {
    "2d": (((-1.0, -1.0), (1.0, 1.0), (17, 23)), lambda m: m.circle((0.1, -0.05), 0.5),
           lambda m: m.circle((-0.2, 0.1), 0.3)),
    "3d": (((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (11, 13, 15)),
           lambda m: m.sphere((0.1, -0.05, 0.0), 0.5),
           lambda m: m.sphere((-0.2, 0.1, 0.05), 0.3)),
}


def _pair(dim, which):
    args, a, b = CASES[dim]
    rng = np.random.default_rng(len(dim) + which)
    shape = (a, b)[which]
    jphi = J.sample(shape(jshapes), J.Grid(*args), J.LinearExtrapolation())
    vals = np.asarray(jphi.values) + 1e-3 * rng.standard_normal(args[2])
    return (jphi.with_values(jnp.asarray(vals)),
            T.MeshField(torch.from_numpy(vals), T.Grid(*args), T.LinearExtrapolation()))


def _close(got, ref):
    got = got.values if isinstance(got, T.MeshField) else got
    ref = ref.values if isinstance(ref, J.MeshField) else ref
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("dim", list(CASES))
@pytest.mark.parametrize("name", ["gradient", "grad_norm", "hessian", "curvature"])
def test_differential_queries_match_jax(name, dim):
    jphi, tphi = _pair(dim, 0)
    _close(getattr(T, name)(tphi), getattr(J, name)(jphi))


@pytest.mark.parametrize("dim", list(CASES))
def test_normal_matches_jax(dim):
    jphi, tphi = _pair(dim, 0)
    _close(T.normal(tphi), J.normal(jphi))
    # a flat field: min_norm bounds the divisor, as in JAX
    jflat, tflat = jphi.with_values(0.0 * jphi.values), tphi.with_values(0.0 * tphi.values)
    _close(T.normal(tflat, min_norm=1e-3), J.normal(jflat, min_norm=1e-3))


@pytest.mark.parametrize("dim", list(CASES))
@pytest.mark.parametrize("name", ["union", "intersection", "difference"])
def test_csg_matches_jax(name, dim):
    (j1, t1), (j2, t2) = _pair(dim, 0), _pair(dim, 1)
    out = getattr(T, name)(t1, t2)
    assert isinstance(out, T.MeshField) and out.grid == t1.grid
    _close(out, getattr(J, name)(j1, j2))


@pytest.mark.parametrize("dim", list(CASES))
def test_complement_and_vector_fields(dim):
    jphi, tphi = _pair(dim, 0)
    _close(T.complement(tphi), J.complement(jphi))
    vec = T.MeshField(torch.stack([tphi.values] * tphi.ndim), tphi.grid, T.LinearExtrapolation())
    with pytest.raises(ValueError, match="real-valued"):
        T.curvature(vec)
