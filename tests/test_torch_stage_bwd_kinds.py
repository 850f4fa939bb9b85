"""Parity of the port's term-list stage backward (K3''s plain version,
``stage_backward_terms_plain``) with the JAX package's ``stage_backward``, on
the CPU in float64, over the normal-motion, curvature and eikonal kinds and
sums of terms (JAX runs its Pallas kernel in interpret mode at the shape it
tiles, its jnp composite below it), and with the port's own autograd oracle;
and of the CPU twin of the kernel's staged factorisation with the plain K3'.

As in ``test_torch_weno_v2_bwd.py``, the two packages store different padded
layouts, so ``dP`` is compared on the interior after each package's own
fold; the cotangent handed to both carries nothing on the port's axis-2
ghosts, which JAX does not store.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.ops import weno_v2 as jv2
from lsm_tpu.ops import weno_v2_bwd as jbwd
from lsm_tpu_torch.ops import coef_program as cp
from lsm_tpu_torch.ops import weno_v2 as tv2
from lsm_tpu_torch.ops import weno_v2_bwd as tbwd


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(a, b):
    """``max|a - b| / max(max|b|, 1)``."""
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


SMALL = (8, 10, 12)
INTERPRET = (16, 32, 128)  # a shape JAX's Pallas backward tiles
SPACING = (0.07, 0.05, 0.06)
LO = (0.0, -1.0, 0.5)
BCS = {"periodic": "Periodic", "extrap1": "LinearExtrapolation", "symmetry": "Symmetry"}
#: the term lists: (kind, coefficient kind) per term
LISTS = {
    "normal stream": (("normal", "stream"),),
    "normal const": (("normal", "const"),),
    "curvature const": (("curvature", "const"),),
    "eikonal stream": (("eikonal", "stream"),),
    "eikonal none": (("eikonal", "none"),),
    "curvature + normal": (("curvature", "const"), ("normal", "stream")),
    "advection + normal": (("advection", "stream"), ("normal", "stream")),
}
CONST = {"normal": 0.2, "curvature": -0.05}


def _inputs(shape, bc, kinds, with_aux, seed):
    """The same stage inputs for both packages: ``(jax_args, port_args)``;
    a streamed scalar has exact zeros (the normal motion's tie)."""
    rng = np.random.default_rng(seed)
    jb = J.normalize_bcs(getattr(J, BCS[bc])(), 3)
    tb = T.normalize_bcs(getattr(T, BCS[bc])(), 3)
    n0, n1, n2 = shape
    vals = rng.standard_normal(shape)
    aux = rng.standard_normal(shape) if with_aux else None
    g = rng.standard_normal(tv2.padded_shape(shape))
    g[:, :, :3] = 0.0
    g[:, :, 3 + n2:] = 0.0
    jterms, tterms = [], []
    for kind, coef in kinds:
        if coef == "stream":
            k = 3 if kind == "advection" else 1
            arrs = rng.standard_normal((k, *shape)) * (0.3 if k == 3 else 1.0)
            if kind == "normal":
                arrs[:, :, ::3] = 0.0
            jterms.append((jv2.TermSpec(kind, "stream", None, k), tuple(jnp.asarray(a) for a in arrs)))
            tterms.append((tv2.TermSpec(kind, "stream", None, k),
                           tuple(torch.from_numpy(a.copy()) for a in arrs)))
        else:
            value = CONST.get(kind)
            jterms.append((jv2.TermSpec(kind, coef, value, 0), ()))
            tterms.append((tv2.TermSpec(kind, coef, value, 0), ()))
    coeffs = (0.3, 0.7, 0.12)
    JP = jv2.pack_padded(jnp.asarray(vals), jb)
    JA = None if aux is None else jv2.pack_padded(jnp.asarray(aux), jb)
    JG = jnp.zeros((n0 + 6, n1 + 16, n2)).at[:, 5:11 + n1, :].set(jnp.asarray(g[:, :, 3:3 + n2]))
    specs = tuple(s for s, _ in jterms)
    streams = tuple(a for _, arrs in jterms for a in arrs)
    j = (JP, streams, tuple(jnp.asarray(c) for c in coeffs), jnp.asarray(0.0), JA, JG, specs,
         tuple(len(a) for _, a in jterms), jb, SPACING, shape, LO)
    TP = tv2.pack_padded(torch.from_numpy(vals), tb)
    TA = None if aux is None else tv2.pack_padded(torch.from_numpy(aux), tb)
    return j, (TP, tuple(tterms), coeffs, TA, torch.from_numpy(g), tb)


def _compare(shape, jargs, targs):
    """The port's plain K3' against JAX's ``stage_backward``: worst error
    of dP (interior, after each fold), the stream cotangents, dcoef and
    daux."""
    TP, terms, coeffs, TA, G, tb = targs
    jdP, jds, jdc, _, jda = jbwd.stage_backward(*jargs, interpret=True)
    gf = tbwd.fold_ghost_cotangent_fast(G.clone(), tb, shape)
    dP, ds, dcoef, daux = tbwd.stage_backward_terms(TP, terms, coeffs, TA, gf, SPACING, shape)
    assert tbwd.stage_backward_terms.launches == tbwd.stage_backward.launches == 0
    errs = {"dP": _err(tbwd.fold_ghost_cotangent(dP, tb, shape),
                       jbwd.fold_ghost_cotangent(jdP, jargs[8], shape)),
            "dcoef": _err(dcoef, np.array([float(c) for c in jdc]))}
    assert len(ds) == len(jds)
    for k, (a, b) in enumerate(zip(ds, jds)):
        errs[f"ds{k}"] = _err(a, b)
    if TA is not None:
        errs["daux"] = _err(tv2.unpack_padded(daux, shape), jv2.unpack_padded(jda, shape))
    else:
        assert daux is None and float(dcoef[0]) == 0.0
    return errs


@pytest.mark.parametrize("bc", list(BCS))
@pytest.mark.parametrize("name", list(LISTS))
def test_stage_backward_terms_matches_jax(name, bc):
    for with_aux in (False, True):
        jargs, targs = _inputs(SMALL, bc, LISTS[name], with_aux, seed=len(name) + 3 * len(bc))
        errs = _compare(SMALL, jargs, targs)
        assert max(errs.values()) <= 1e-10, (with_aux, errs)


@pytest.mark.parametrize("name", ["curvature + normal", "eikonal none"])
def test_stage_backward_terms_matches_jax_pallas_kernel(name):
    """Against the JAX Pallas backward itself (interpret mode), whose
    non-advection parts run one ``jax.vjp`` each inside the kernel."""
    jargs, targs = _inputs(INTERPRET, "periodic", LISTS[name], True, seed=11)
    errs = _compare(INTERPRET, jargs, targs)
    assert max(errs.values()) <= 1e-10, errs


@pytest.mark.parametrize("bc", list(BCS))
def test_stage_backward_terms_matches_autograd_oracle(bc):
    """The plain K3' after the plain fold against ``torch.autograd`` of stage
    plus refresh, raw dP included (tie-free BCs), on every term list."""
    for name, kinds in LISTS.items():
        _, (TP, terms, coeffs, TA, _, tb) = _inputs(SMALL, bc, kinds, True, seed=len(name))
        G = torch.from_numpy(np.random.default_rng(4).standard_normal(TP.shape))  # all shells
        gf = tbwd.fold_ghost_cotangent_plain(G.clone(), tb, SMALL)
        got = tbwd.stage_backward_terms_plain(TP, terms, coeffs, TA, gf, SPACING, SMALL)
        ref = tbwd.composite_backward_autograd(TP, terms, coeffs, TA, G, tb, SPACING, SMALL)
        assert _err(got[0], ref[0]) <= 1e-12, name
        for a, b in zip(got[1], ref[1]):
            assert _err(a, b) <= 1e-12, name
        assert _err(got[2], ref[2]) <= 1e-12 and _err(got[3], ref[3]) <= 1e-12, name


def test_zero_speed_takes_the_half_split():
    """Normal motion at a speed that is exactly 0: autodiff of max(v, 0) and
    min(v, 0) gives each side half, so dv = 0.5 |grad+| + 0.5 |grad-| times
    the cotangent, in both packages; the port's value equals JAX's there."""
    jargs, targs = _inputs(SMALL, "periodic", LISTS["normal stream"], False, seed=21)
    TP, terms, coeffs, _, G, tb = targs
    zero = terms[0][1][0] == 0.0
    assert int(zero.sum()) > 0
    jds = jbwd.stage_backward(*jargs, interpret=True)[1]
    gf = tbwd.fold_ghost_cotangent_fast(G.clone(), tb, SMALL)
    ds = tbwd.stage_backward_terms(TP, terms, coeffs, None, gf, SPACING, SMALL)[1]
    np.testing.assert_allclose(_np(ds[0])[_np(zero)], np.asarray(jds[0])[_np(zero)], rtol=0,
                               atol=1e-12)
    gp, gm = tv2.st.godunov_norms(TP, SPACING, tv2.GHOST, SMALL)
    half = -coeffs[2] * tv2.unpack_padded(gf, SMALL) * (0.5 * gp + 0.5 * gm)
    assert _err(ds[0][zero], half[zero]) <= 1e-14


def test_fused_step_stage_runs_k3_prime_on_a_term_list():
    """``fused_step_stage`` of a term list differentiates through the fold,
    K3' and the shell zeroing (here their plain versions), with gradients to
    P, the streams, aux and tensor coefficients equal to the autograd
    oracle's."""
    jargs, (TP, terms, coeffs, TA, G, tb) = _inputs(SMALL, "extrap1",
                                                    LISTS["advection + normal"], True, seed=5)
    P = TP.clone().requires_grad_()
    A = TA.clone().requires_grad_()
    streams = [a.clone().requires_grad_() for _, arrs in terms for a in arrs]
    live = ((terms[0][0], tuple(streams[:3])), (terms[1][0], (streams[3],)))
    gamma = torch.tensor(coeffs[2], dtype=torch.float64, requires_grad=True)
    out = tv2.fused_step_stage(P, live, (coeffs[0], coeffs[1], gamma), A, tb, SPACING, SMALL)
    got = torch.autograd.grad(out, (P, A, gamma, *streams), grad_outputs=G)
    ref = tbwd.composite_backward_autograd(TP, terms, coeffs, TA, G, tb, SPACING, SMALL)
    assert _err(got[0], ref[0]) <= 1e-12 and _err(got[1], ref[3]) <= 1e-12
    assert _err(got[2], ref[2][2]) <= 1e-12
    for a, b in zip(got[3:], ref[1]):
        assert _err(a, b) <= 1e-12


# -- the CPU twin of K3''s staged factorisation ------------------------------------------

TWIN_BCS = {"periodic": lambda: T.Periodic(), "extrap1": lambda: T.LinearExtrapolation(),
            "extrap2": lambda: T.Extrapolation(2)}


def _speed(xs, t):
    """A time-dependent normal speed, traced into a program."""
    x, y, z = xs
    return 0.1 + 0.05 * x + 0.02 * t * y


#: config A's curvature + streamed normal motion, config C's normal motion,
#: both eikonal sign forms, a program speed whose stage time needs a
#: cotangent, and an advection term beside normal motion
TWIN_LISTS = {
    "config A": (("curvature", "const"), ("normal", "stream")),
    "config C": (("normal", "stream"),),
    "eikonal frozen": (("eikonal", "stream"),),
    "eikonal none": (("eikonal", "none"),),
    "program + dt": (("normal", "program"), ("curvature", "stream")),
    "advection + normal": (("advection", "stream"), ("normal", "stream")),
}


def _twin_inputs(bc, kinds, with_aux, seed):
    """The port's stage-backward inputs from numpy's generator: ``(P, terms,
    aux, g, bcs)``; a streamed normal speed has exact zeros (its tie)."""
    rng = np.random.default_rng(seed)
    bcs = T.normalize_bcs(TWIN_BCS[bc](), 3)
    P = tv2.pack_padded(torch.from_numpy(rng.standard_normal(SMALL)), bcs)
    aux = tv2.pack_padded(torch.from_numpy(rng.standard_normal(SMALL)), bcs) if with_aux else None
    g = torch.from_numpy(rng.standard_normal(tv2.padded_shape(SMALL)))
    terms = []
    for kind, coef in kinds:
        if coef == "stream":
            k = 3 if kind == "advection" else 1
            arrs = rng.standard_normal((k, *SMALL)) * (0.3 if k == 3 else 1.0)
            if kind == "normal":
                arrs[:, :, ::3] = 0.0
            terms.append((tv2.TermSpec(kind, "stream", None, k),
                          tuple(torch.from_numpy(a.copy()) for a in arrs)))
        elif coef == "program":
            terms.append((tv2.TermSpec(kind, "program", cp.trace(_speed, 3, 1)), ()))
        else:
            terms.append((tv2.TermSpec(kind, coef, CONST.get(kind), 0), ()))
    return P, tuple(terms), aux, g, bcs


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("name", list(TWIN_LISTS))
@pytest.mark.parametrize("bc", list(TWIN_BCS))
def test_staged_twin_matches_plain(bc, name, with_aux):
    """The CPU twin of K3''s design (each output's Godunov and curvature
    pieces once, then dP gathered with the kernel's weights) against the
    plain K3' (autograd of the plain Hamiltonians) in float64: dP, the stream
    cotangents, dcoef (the stage time's cotangent included) and daux, within
    1e-12 of max|ref|."""
    P, terms, aux, g, bcs = _twin_inputs(bc, TWIN_LISTS[name], with_aux, seed=len(name) + len(bc))
    gf = tbwd.fold_ghost_cotangent_plain(g.clone(), bcs, SMALL)
    where = tv2.Where(LO, (3.0, -5.0, 7.0), 0.3)
    coeffs = (0.3, 0.7, 0.12)
    ref = tbwd.stage_backward_terms_plain(P, terms, coeffs, aux, gf, SPACING, SMALL, where=where,
                                          need_dt=True)
    got = tbwd.stage_backward_terms_staged(P, terms, coeffs, aux, gf, SPACING, SMALL,
                                           where=where, need_dt=True)
    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
    assert rel(got[0], ref[0]) <= 1e-12, name
    assert len(got[1]) == len(ref[1])
    for a, b in zip(got[1], ref[1]):
        assert torch.equal(a, b) if float(b.abs().max()) == 0.0 else rel(a, b) <= 1e-12
    assert got[2].shape == ref[2].shape and rel(got[2], ref[2]) <= 1e-12
    if with_aux:
        assert rel(got[3], ref[3]) <= 1e-12
    else:
        assert got[3] is None and ref[3] is None
