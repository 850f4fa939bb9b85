"""The port's public surface against the JAX package's: the same 46 names in
``__all__`` (and ``interp``'s and ``geometry``'s; ``core``'s, ``terms``',
``utils``' and ``io``'s re-exports), a walk of every ``lsm_tpu`` module's
top-level names (read with ``ast``, not imported) against its counterpart
file's, ``Grid``'s methods with JAX's semantics, the left- and right-biased
WENO5 derivatives and their fused pair, and, in a subprocess where ``jax``
and ``lsm_tpu`` cannot be imported, every module of ``lsm_tpu_torch`` and
``chip_smoke.py`` importing.
"""

import ast
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


#: what JAX's subpackages re-export that the port does not: nothing
NOT_YET = {}


@pytest.mark.parametrize("sub", ["core", "terms", "utils", "io"])
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
    if sub == "io":  # JAX's eight names and no more
        assert {n for n in dir(tm) if not n.startswith("_")
                and not isinstance(getattr(tm, n), type(tm))} == public and len(public) == 8


#: JAX modules whose port lives in a file of another name: the TPU lane
#: layout's modules, whose CUDA counterparts keep no Pallas names (the walk
#: checks that the file exists, not its names)
RENAMED = {"ops/band_pallas.py": "ops/band.py", "ops/weno_pallas.py": "ops/weno_general.py"}
#: top-level names of JAX modules the port leaves out: the gates that ask
#: whether a TPU kernel takes a configuration
TPU_GATES = {"ops/weno_v2.py": {"supports_v2"}, "ops/weno_v2_bwd.py": {"supports_stage_bwd"}}


def top_level_names(path):
    """The public top-level names a module defines, by ``ast``: functions,
    classes and assigned names (also under a top-level ``if``/``try``), and
    in a package's ``__init__.py`` what it imports from its own package."""
    tree = ast.parse(open(path).read())
    out = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                out.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
            elif (isinstance(node, ast.ImportFrom) and node.level
                  and os.path.basename(path) == "__init__.py"):
                out.update(a.asname or a.name for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)

    visit(tree.body)
    return {n for n in out if not n.startswith("_")}


def test_every_jax_module_has_its_names_in_the_port():
    """Every ``lsm_tpu/**/*.py`` has a counterpart file in ``lsm_tpu_torch/``
    whose top-level public names include JAX's, apart from :data:`RENAMED`
    and :data:`TPU_GATES`, which must each still be needed."""
    jroot, troot = os.path.join(ROOT, "lsm_tpu"), os.path.join(ROOT, "lsm_tpu_torch")
    walked, missing = 0, {}
    for dirpath, _, files in os.walk(jroot):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), jroot).replace(os.sep, "/")
            walked += 1
            if rel in RENAMED:
                assert not os.path.exists(os.path.join(troot, rel)), rel
                assert os.path.isfile(os.path.join(troot, RENAMED[rel])), rel
                continue
            port = os.path.join(troot, rel)
            assert os.path.isfile(port), f"no counterpart of lsm_tpu/{rel}"
            gap = top_level_names(os.path.join(dirpath, f)) - top_level_names(port)
            if gap:
                missing[rel] = gap
    assert walked >= 40
    assert missing == TPU_GATES, missing


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


def test_weno5_pair_matches_jax():
    rng = np.random.default_rng(5)
    dm = rng.standard_normal((6, 4000)) * rng.choice([1e-3, 1.0, 30.0], size=(1, 4000))
    dm[:, :50] = 0.0  # flat stencils: the epsilon's floor
    dm[:3, 50:100] = 1.5  # one side flat
    want = jst.weno5_pair([jnp.asarray(d) for d in dm])
    got = tst.weno5_pair([torch.from_numpy(d) for d in dm])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and np.abs(g.numpy() - w).max() <= 1e-14 * np.abs(w).max()
    # the pair is the left- and right-biased WENO5 derivatives of a padded line
    p = rng.standard_normal(40)
    h, shape = 0.1, (34,)
    dms = [torch.from_numpy((p[k + 1:k + 35] - p[k:k + 34]) / h) for k in range(6)]
    minus, plus = tst.weno5_pair(dms)
    ref = torch.from_numpy(p)
    assert torch.allclose(minus, tst.weno5m(ref, 0, h, 3, shape), rtol=1e-12, atol=1e-12)
    assert torch.allclose(plus, tst.weno5p(ref, 0, h, 3, shape), rtol=1e-12, atol=1e-12)


def test_coefficient_alias_matches_jax():
    import typing

    from lsm_tpu.terms import terms as jterms
    from lsm_tpu_torch.terms import terms as tterms

    jargs, targs = typing.get_args(jterms.Coefficient), typing.get_args(tterms.Coefficient)
    assert len(targs) == len(jargs) == 3
    assert targs[0] is T.MeshField and targs[1] is torch.Tensor
    assert jargs[0] is J.MeshField and targs[2] is jargs[2]


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
