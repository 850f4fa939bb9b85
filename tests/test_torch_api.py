"""The port's public surface against the JAX package's: the same 46 names in
``__all__`` (and ``interp``'s and ``geometry``'s; ``core``'s, ``terms``'
and ``utils``' re-exports), ``Grid``'s methods with
JAX's semantics, the left- and right-biased WENO5 derivatives, and, in a
subprocess where ``jax`` and ``lsm_tpu`` cannot be imported, every module of
``lsm_tpu_torch`` and ``chip_smoke.py`` importing.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.ops import stencils as jst
from lsm_tpu_torch.ops import stencils as tst

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_public_names_match_jax():
    assert set(T.__all__) == set(J.__all__) and len(T.__all__) == 46
    assert all(hasattr(T, name) for name in T.__all__)
    import lsm_tpu.geometry as jgeo
    import lsm_tpu.interp as jinterp
    import lsm_tpu_torch.geometry as tgeo
    import lsm_tpu_torch.interp as tinterp

    for jm, tm in ((jinterp, tinterp), (jgeo, tgeo)):
        public = {n for n in dir(jm) if not n.startswith("_") and callable(getattr(jm, n))}
        assert public <= set(dir(tm)), public - set(dir(tm))
    assert "SemiImplicitI2OE" in dir(T.integrators)


#: what JAX's subpackages re-export that the port does not yet: utils'
#: profiling names, which come with the port of ``utils/profiling.py``
NOT_YET = {"utils": {"StepMonitor", "trace", "timed"}}


@pytest.mark.parametrize("sub", ["core", "terms", "utils"])
def test_subpackage_reexports_match_jax(sub):
    """``from lsm_tpu_torch.<sub> import <name>`` works for every name JAX's
    ``lsm_tpu.<sub>`` re-exports, apart from :data:`NOT_YET`."""
    import importlib

    jm = importlib.import_module(f"lsm_tpu.{sub}")
    tm = importlib.import_module(f"lsm_tpu_torch.{sub}")
    public = {n for n in dir(jm) if not n.startswith("_")
              and not isinstance(getattr(jm, n), type(jm))}
    assert public - set(dir(tm)) == NOT_YET.get(sub, set())
    for name in public - NOT_YET.get(sub, set()):
        assert getattr(tm, name) is getattr(T, name, getattr(tm, name))


@pytest.mark.parametrize("shape", [(5, 7, 9), (4, 6)])
def test_grid_methods_match_jax(shape):
    lo, hi = (-1.0, 0.5, 2.0)[:len(shape)], (1.0, 2.0, 3.5)[:len(shape)]
    jg, tg = J.Grid(lo, hi, shape), T.Grid(lo, hi, shape)
    assert tg.cells_shape == jg.cells_shape and tg.num_nodes == jg.num_nodes
    assert tg.node((1, 2, 3)[:len(shape)]) == jg.node((1, 2, 3)[:len(shape)])
    assert tg.node((-1, 9, 0)[:len(shape)]) == jg.node((-1, 9, 0)[:len(shape)])  # ghosts
    assert tg.cell_center((0, 1, 2)[:len(shape)]) == jg.cell_center((0, 1, 2)[:len(shape)])
    for a, b in zip(tg.dense_coords(device="cpu"), jg.dense_coords()):  # linspace: to an ulp
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)
    assert tg.dense_coords(torch.float32, "cpu")[0].dtype == torch.float32
    x = np.random.default_rng(0).uniform(-3.0, 4.0, (50, len(shape)))
    x[0] = lo  # on the lower corner, on the upper one (clamped into the last cell)
    x[1] = hi
    got = tg.locate_cell(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jg.locate_cell(jnp.asarray(x))))
    for ms in (0.3, (0.3, 0.25, 0.7)[:len(shape)], 1.5):
        a, b = T.Grid.from_meshsize(lo, hi, ms), J.Grid.from_meshsize(lo, hi, ms)
        assert (a.lo, a.hi, a.shape) == (b.lo, b.hi, b.shape)
    with pytest.raises(ValueError, match="positive"):
        T.Grid.from_meshsize(lo, hi, 0.0)
    with pytest.raises(ValueError, match="one entry per dimension"):
        T.Grid.from_meshsize(lo, hi, (0.1,) * (len(shape) + 1))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_weno5_biased_derivatives_match_jax(axis):
    shape = (9, 10, 11)
    rng = np.random.default_rng(axis)
    p = rng.standard_normal(tuple(n + 6 for n in shape))
    p[:, :, :4] = 0.5  # flat stencils: the floor of the weights' epsilon
    h = 0.1 + 0.05 * axis
    for jf, tf in ((jst.weno5m, tst.weno5m), (jst.weno5p, tst.weno5p)):
        want = np.asarray(jf(jnp.asarray(p), axis, h, 3, shape))
        got = tf(torch.from_numpy(p), axis, h, 3, shape).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_modules_import_without_jax():
    """Every module of the port, and chip_smoke.py, imports in a process
    where ``jax`` and ``lsm_tpu`` are unimportable."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "lsm_tpu"):
    sys.modules[name] = None
import lsm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lsm_tpu_torch.__path__, "lsm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "lsm_tpu."))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 40
