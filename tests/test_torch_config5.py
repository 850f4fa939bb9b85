"""Configuration 5 and the velocity extension it runs, on the CPU in float64:
the port's ``extend_along_normals`` (values and gradients) against the JAX
package's, and ``config5_shape_opt_3d``'s loss and gradients against
``jax.value_and_grad`` of JAX's configuration 5 at the same arguments, on
both packages' general band path; the port's band stepper on the same loss
against its general path.

The configuration's sphere is mirror-symmetric on a symmetric grid, so its
upwind and minmod comparisons tie exactly, and two formulations that round
differently take different subgradients there (0.3 % of the gradient's max
at n = 24). The gradient checks therefore add 1e-6 of seeded noise to phi0,
as the JAX package's own band-gradient tests use tie-free data; the loss is
also compared on the exact sphere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.models import benchmarks as jbench
from lsm_tpu.models import shapes as jshapes
from lsm_tpu_torch.integrators import loop as tloop
from lsm_tpu_torch.models import benchmarks as tbench


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _fields(shape=(14, 16, 18), bc="LinearExtrapolation"):
    """An off-centre sphere (with noise) and a speed, in both packages."""
    args = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), shape)
    rng = np.random.default_rng(3)
    jphi = J.sample(jshapes.sphere((0.05, -0.1, 0.02), 0.5), J.Grid(*args), getattr(J, bc)())
    vals = np.asarray(jphi.values) + 1e-3 * rng.standard_normal(shape)
    speed = 0.1 + 0.05 * rng.standard_normal(shape)
    jphi = jphi.with_values(jnp.asarray(vals))
    tphi = T.MeshField(torch.from_numpy(vals), T.Grid(*args), getattr(T, bc)())
    return jphi, tphi, speed


@pytest.mark.parametrize("kind", ["default band", "given mask", "meshfield"])
def test_extend_along_normals_matches_jax(kind):
    jphi, tphi, speed = _fields()
    kw = {"nb_iters": 12}
    if kind == "given mask":
        frozen = np.abs(np.asarray(jphi.values)) <= 0.2
        jkw, tkw = dict(kw, frozen=jnp.asarray(frozen)), dict(kw, frozen=torch.from_numpy(frozen))
    else:
        jkw, tkw = kw, kw
    if kind == "meshfield":
        jF, tF = J.MeshField(jnp.asarray(speed), jphi.grid), T.MeshField(torch.from_numpy(speed),
                                                                        tphi.grid)
    else:
        jF, tF = jnp.asarray(speed), torch.from_numpy(speed)
    jout = J.extend_along_normals(jF, jphi, **jkw)
    tout = T.extend_along_normals(tF, tphi, **tkw)
    if kind == "meshfield":
        assert isinstance(tout, T.MeshField) and tout.grid == tphi.grid
        jout, tout = jout.values, tout.values
    assert _err(tout, jout) <= 1e-12
    # far nodes moved, frozen ones did not
    assert float((tout - torch.from_numpy(speed)).abs().max()) > 0


def test_extend_along_normals_gradient_reaches_phi():
    """``jax.grad`` of a loss of the extended speed w.r.t. phi and F: the
    gradient flows to phi through the signed-normal components."""
    jphi, tphi, speed = _fields()
    w = np.random.default_rng(9).standard_normal(speed.shape)

    def jloss(v, f):
        return jnp.sum(w * J.extend_along_normals(f, jphi.with_values(v), nb_iters=6) ** 2)

    jgv, jgf = jax.grad(jloss, argnums=(0, 1))(jphi.values, jnp.asarray(speed))
    v = tphi.values.clone().requires_grad_()
    f = torch.from_numpy(speed).requires_grad_()
    out = T.extend_along_normals(f, tphi.with_values(v), nb_iters=6)
    gv, gf = torch.autograd.grad((torch.from_numpy(w) * out ** 2).sum(), (v, f))
    assert float(gv.abs().max()) > 0
    assert _err(gv, jgv) <= 1e-12 and _err(gf, jgf) <= 1e-12


def test_extend_along_normals_checks_its_arguments():
    _, tphi, speed = _fields()
    F = torch.from_numpy(speed)
    bad = [({"nb_iters": -1}, "nb_iters must be non-negative"),
           ({"cfl": 0.0}, "cfl must be strictly positive"),
           ({"interface_band": -1.0}, "interface_band must be non-negative"),
           ({"min_norm": -1.0}, "min_norm must be non-negative"),
           ({"frozen": torch.zeros((3, 3, 3), dtype=torch.bool)}, "frozen mask must have the same"),
           ({"frozen": torch.zeros(tphi.shape)}, "frozen mask must contain Bool")]
    for kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            T.extend_along_normals(F, tphi, **kw)
    with pytest.raises(ValueError, match="same size"):
        T.extend_along_normals(F[1:], tphi)
    with pytest.raises(ValueError, match="floating-point"):
        T.extend_along_normals(torch.ones(tphi.shape, dtype=torch.int64), tphi)
    other = T.Grid((-1.0, -1.0, -1.0), (2.0, 1.0, 1.0), tphi.shape)
    with pytest.raises(ValueError, match="same mesh"):
        T.extend_along_normals(T.MeshField(F, other), tphi)
    # a field without BCs takes linear extrapolation, as in JAX
    bare = T.MeshField(tphi.values, tphi.grid)
    ref = T.extend_along_normals(F, tphi.with_bcs(T.LinearExtrapolation(), replace=True),
                                 nb_iters=3)
    assert torch.equal(T.extend_along_normals(F, bare, nb_iters=3), ref)


N5, STEPS5 = 24, 2


@pytest.fixture(scope="module")
def config5():
    """JAX's and the port's configuration 5 at n = 24, 2 steps, float64,
    and the perturbed phi0 both are differentiated at."""
    jfn, jphi0, jspeed0 = jbench.config5_shape_opt_3d(n=N5, nsteps=STEPS5, dtype=jnp.float64)
    tfn, tphi0, tspeed0 = tbench.config5_shape_opt_3d(n=N5, nsteps=STEPS5, dtype=torch.float64,
                                                      device="cpu")
    vals = np.asarray(jphi0.values) + 1e-6 * np.random.default_rng(5).standard_normal(
        (N5,) * 3)
    return jfn, tfn, jphi0, tphi0, np.array(jspeed0), tspeed0, vals


def test_config5_matches_jax_value_and_grad(config5):
    jfn, tfn, jphi0, tphi0, jspeed, tspeed, vals = config5
    assert _err(tphi0.values, jphi0.values) <= 1e-15 and torch.equal(
        tspeed, torch.from_numpy(jspeed))
    assert tphi0.values.device.type == "cpu" and isinstance(tphi0.bcs[0][0], T.Extrapolation)
    jl0, _ = jfn(jphi0.values, jnp.asarray(jspeed))
    tl0, _ = tfn(tphi0.values, tspeed)
    assert abs(float(tl0) - float(jl0)) <= 1e-9 * abs(float(jl0))
    jl, (jdp, jds) = jfn(jnp.asarray(vals), jnp.asarray(jspeed))
    tl, (tdp, tds) = tfn(torch.from_numpy(vals), tspeed)
    assert abs(float(tl) - float(jl)) <= 1e-9 * abs(float(jl))
    for a, b in ((tdp, jdp), (tds, jds)):
        b = np.asarray(b)
        assert float(np.abs(b).max()) > 0
        assert np.abs(_np(a) - b).max() <= 1e-9 * np.abs(b).max()


def test_config5_band_stepper_matches_the_general_path(config5, monkeypatch):
    """On the card configuration 5's rollout is the band stepper; here it is
    forced onto the stepper (its kernels' plain versions) and held to the
    CPU's general band path."""
    _, tfn, _, _, _, tspeed, vals = config5
    tl, (tdp, tds) = tfn(torch.from_numpy(vals), tspeed)
    monkeypatch.setattr(tbench, "rollout",
                        lambda integ, terms, phi, t0, dt, n: tloop._band_rollout(
                            integ, terms, phi, t0, dt, n))
    bl, (bdp, bds) = tfn(torch.from_numpy(vals), tspeed)
    assert abs(float(bl) - float(tl)) <= 1e-10 * abs(float(tl))
    assert _err(bdp, tdp) <= 1e-10 * max(float(tdp.abs().max()), 1.0)
    assert float((bds - tds).abs().max()) <= 1e-10 * float(tds.abs().max())
