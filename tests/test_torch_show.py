"""Display pinning for the port: JAX's ``tests/test_show.py`` against
``lsm_tpu_torch`` on ``device="cpu"`` in float64. Each pinned line is also
held against JAX's ``repr`` of the same inputs: a tree's first line, and the
equation's ``state:`` line, are JAX's exactly. The device, which JAX does
not print, has a line of its own at the end of the tree.
"""

import jax.numpy as jnp
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T

F64 = dict(dtype=torch.float64, device="cpu")


def _lines(obj):
    return repr(obj).splitlines()


def _pair(shape=(5, 5), lo=(-1, -1), hi=(1, 1)):
    """JAX's and the port's field of ``x^2 + y^2 - 0.25``."""
    fn = lambda X, Y: X**2 + Y**2 - 0.25
    return (J.sample(fn, J.Grid(lo, hi, shape)),
            T.sample(fn, T.Grid(lo, hi, shape), **F64))


def test_grid_show():
    g, jg = T.Grid((0, 0), (1, 1), (10, 4)), J.Grid((0, 0), (1, 1), (10, 4))
    s = repr(g)
    assert s.startswith("Grid in R^2")
    assert "domain:  [0, 1] x [0, 1]" in s
    assert "nodes:   10 x 4" in s
    assert "spacing: h = (0.1111, 0.3333)" in s
    assert s == repr(jg)


@pytest.mark.parametrize("name, want", [
    ("Periodic", "Periodic"), ("Neumann", "Neumann"),
    ("LinearExtrapolation", "Linear extrapolation"), ("Symmetry", "Symmetry")])
def test_bc_show(name, want):
    assert str(getattr(T, name)()) == want == str(getattr(J, name)())
    assert str(T.Extrapolation(4)) == "Degree 4 extrapolation" == str(J.Extrapolation(4))


def test_meshfield_show():
    jphi, phi = _pair()
    s = repr(phi)
    assert s.startswith("MeshField (scalar, float64)")
    assert "grid: 5 x 5 nodes in R^2" in s
    assert "bcs:  none" in s
    assert _lines(phi)[0] == _lines(jphi)[0]
    assert _lines(phi)[-1] == "  `- device: cpu"
    assert _lines(phi)[1:-1] == [line.replace("`-", "|-") for line in _lines(jphi)[1:]]

    s = repr(phi.with_bcs(T.Neumann()))
    assert "bcs:  Neumann (all)" in s

    vec = lambda X, Y: (X, Y)
    u = T.sample(vec, T.Grid((-1, -1), (1, 1), (5, 5)), vector=True, **F64)
    ju = J.sample(vec, J.Grid((-1, -1), (1, 1), (5, 5)), vector=True)
    assert repr(u).startswith("MeshField (vector, float64)")
    assert _lines(u)[0] == _lines(ju)[0]

    s = repr(phi.with_bcs([T.Neumann(), T.Symmetry()]))
    assert "x: Neumann" in s and "y: Symmetry" in s


def test_narrowband_show():
    fn = lambda sqrt: lambda X, Y: sqrt(X**2 + Y**2) - 0.5
    grid, jgrid = T.Grid((-2, -2), (2, 2), (40, 40)), J.Grid((-2, -2), (2, 2), (40, 40))
    nb = T.NarrowBandField.from_field(
        T.sample(fn(torch.sqrt), grid, T.Extrapolation(2), **F64))
    jnb = J.NarrowBandField.from_field(J.sample(fn(jnp.sqrt), jgrid, J.Extrapolation(2)))
    s = repr(nb)
    assert s.startswith("NarrowBandField")
    assert "active:" in s and "3-layer halo" in s
    assert "Degree 2 extrapolation (all)" in s
    assert _lines(nb)[0] == _lines(jnb)[0] == "NarrowBandField (float64)"
    assert _lines(nb)[-1] == "  `- device: cpu"


def test_integrator_show():
    assert repr(T.RK3()).splitlines()[0] == "RK3 (3rd order TVD Runge-Kutta)"
    assert "cfl: 0.3" in repr(T.ForwardEuler(cfl=0.3))
    assert repr(T.SemiImplicitI2OE()).splitlines()[0].startswith("SemiImplicitI2OE")
    for name in ("RK3", "ForwardEuler", "SemiImplicitI2OE"):
        assert repr(getattr(T, name)()) == repr(getattr(J, name)())


def test_equation_show():
    jphi, phi = _pair()
    eq = T.LevelSetEquation(terms=T.NormalMotionTerm(1.0), ic=phi, bc=T.Neumann())
    jeq = J.LevelSetEquation(terms=J.NormalMotionTerm(1.0), ic=jphi, bc=J.Neumann())
    s = repr(eq)
    assert "phi_t + NormalMotionTerm = 0" in s
    assert "integrator: RK3 (3rd order TVD Runge-Kutta)" in s
    assert "t: 0.0" in s
    assert "state: (5, 5) float64" in s
    state = [line for line in _lines(eq) if "state:" in line]
    jstate = [line for line in _lines(jeq) if "state:" in line]
    assert [line[5:] for line in state] == [line[5:] for line in jstate] == [
        "state: (5, 5) float64"]
    assert _lines(eq)[:-2] == _lines(jeq)[:-1]
    assert _lines(eq)[-1] == "  `- device: cpu"
