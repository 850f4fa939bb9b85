"""Torch models of the 2D stage adjoints' marches (``csrc/stage_backward.cu``
``stage_bwd_2d_kernel``, K3 and K3″ 2D, and ``stage_bwd_terms_2d_kernel``,
K3′ 2D), on the CPU in float64, at small ragged sizes.

Each model runs the kernel's blocks (a block of ``nt`` columns marching
over a chunk of padded rows), its steps and its rows in the kernel's order,
one torch vector a block's threads, and records every element it writes.

- K3/K3″: a step stages ``nr`` rows; the outputs of axis 1 over the columns
  and a halo of 3, then each column's outputs along axis 0 from a ring of
  seven P values into a ring of edge cotangents, with c_1 from the held rows
  (a step's rows are at least 6 below the rows it writes). Its dP, du and daux equal, bit for bit,
  the sums in the order of one plane a block (the kernel before the march):
  ``((beta*g + 0) + c_0 term) + c_1 term``, each edge cotangent summed from
  the output two nodes up down to the one three nodes down; both equal
  :func:`stage_backward_plain` to round-off (which associates the axes'
  terms otherwise), and du and daux bit for bit.
- K3′: a block of ``nt`` threads owns ``nt - 4`` columns (the others are
  their halo of 2); row by row, each thread's output's pieces (the staged
  twin's), its own node's sends along the march in a ring of five rows, the
  gather along the row and curvature's mixed differences into the rows
  either side; held to :func:`stage_backward_terms_staged` to round-off.

The sizes cross the marches' boundaries: rows 2-3, a chunk and one row
(the last chunk of one row), a last step short, widths below the block's
and one column past it; Periodic, Extrapolation(1) and (2), Symmetry. Every
dP element (and every du element) is written exactly once. Inputs come from
numpy seeds.
"""

import numpy as np
import pytest
import torch

import lsm_tpu_torch as T
from lsm_tpu_torch.integrators.fused import FusedStepper
from lsm_tpu_torch.models import shapes
from lsm_tpu_torch.ops import stencils as st
from lsm_tpu_torch.ops import weno_v2 as v2
from lsm_tpu_torch.ops import weno_v2_bwd as bwd

G = v2.GHOST
E = T.Extrapolation


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits_equal(a, b):
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int64), b.view(torch.int64)))


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _inside(c, n):
    return (c >= G) & (c < n + G)


def _chunks(S0, chunk):
    """The kernel's chunks of padded rows: ``[(i0, i1)]``."""
    return [(i0, min(i0 + chunk, S0)) for i0 in range(0, S0, chunk)]


def _chunk_len(S0, most=64):
    """The kernel's chunk: at most ``most`` rows, as even as ``S0`` allows."""
    n = -(-S0 // most)
    return -(-S0 // n)


def _velocity(u, spacing, shape, P, where):
    """The two components at every interior output: streams as given, a
    program (the embedding's) as its plain values."""
    if isinstance(u, (tuple, list)):
        return tuple(u)
    vals, _ = bwd._program_coefs(v2.TermSpec("advection", "program", u), P, spacing, shape,
                                 where, False)
    return tuple(vals)


# -- K3 and K3″ 2D --------------------------------------------------------------------


def k3_march_2d(P, u, coeffs, aux, g, spacing, shape, where=None, out=None, nt=128, nr=6,
                chunk=None):
    """The march of ``stage_bwd_2d_kernel``: ``(dP, du, daux, writes,
    du_writes)``, ``writes`` the times each dP element was written.
    ``out``: accumulate mode (dP added to ``out``, no beta*g, no daux).
    ``nr`` is at most 6, as the kernel's: each row's c_1 is held by an
    earlier step."""
    assert nr <= 6, nr
    n0, n1 = shape
    S0, S1 = n0 + 2 * G, n1 + 2 * G
    WG = nt + 2 * G
    alpha, beta, gamma = (float(c) for c in coeffs)
    inv_h = [1.0 / float(h) for h in spacing]
    vel = _velocity(u, spacing, shape, P, where)
    prog = not isinstance(u, (tuple, list))
    dtype = P.dtype
    zero = torch.zeros((), dtype=dtype)
    Gi = torch.zeros_like(P)  # g on the interior, 0 elsewhere (as the kernel stages it)
    v2.unpack_padded(Gi, shape).copy_(v2.unpack_padded(g, shape))
    U = []
    for d in range(2):  # each component on the padded layout, 0 off the interior
        x = torch.zeros_like(P)
        v2.unpack_padded(x, shape).copy_(vel[d])
        U.append(x)
    dP = torch.zeros_like(P) if out is None else out
    writes = torch.zeros(P.shape, dtype=torch.int64)
    du = None if prog else (torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype))
    du_writes = torch.zeros((2, *shape), dtype=torch.int64)
    daux = None
    if aux is not None and out is None:
        daux = torch.zeros_like(P)

    def at(A, row, cols):  # A[row, cols], 0 off the buffer
        ok = (cols >= 0) & (cols < S1) & (0 <= row < S0)
        return torch.where(ok, A[min(max(row, 0), S0 - 1)][cols.clamp(0, S1 - 1)], zero)

    def adjoint(dm, uv, gv):  # ddm and the velocity's cotangent core * (-gamma*g)
        _, ddm, du_ = st.weno5_upwind_fwd_bwd(dm, uv, -gamma * gv)
        return ddm, du_

    chunk = chunk or _chunk_len(S0)
    for k0 in range(0, S1, nt):
        t = torch.arange(nt)
        k = k0 + t
        col, kin = k < S1, _inside(k, n1)
        xs = k0 - G + torch.arange(WG)  # the axis-1 outputs' columns: this block's and a halo
        for i0, i1 in _chunks(S0, chunk):
            nsteps = -(-(i1 - i0 + 2 * G) // nr)
            pr = [at(P, i1 + q, k) for q in range(6)] + [torch.zeros(nt, dtype=dtype)]
            cz = [torch.zeros(nt, dtype=dtype) for _ in range(7)]
            hold = [at(Gi, i1 + j, k) for j in range(G)] + [at(U[0], i1 + j, k) for j in range(G)]
            c1s = {}  # c_1 of the held rows
            for s in range(nsteps):
                b = i1 - (s + 1) * nr
                # axis 1: the outputs of the step's rows in the chunk over xs
                D = {}
                for r in range(nr):
                    row = b + r
                    if row < i0:
                        continue
                    ok = _inside(torch.tensor(row), n0) & _inside(xs, n1)
                    pc = [at(P, row, xs + o) for o in range(-3, 4)]
                    dm = [(pc[q + 1] - pc[q]) * inv_h[1] for q in range(6)]
                    ddm, dux = adjoint(dm, at(U[1], row, xs), at(Gi, row, xs))
                    D[r] = [torch.where(ok, x, zero) for x in ddm]
                    own = ok[G:G + nt] & col
                    if own.any():  # this block's outputs (their row interior)
                        if du is not None:
                            du[1][row - G, k[own] - G] = dux[G:G + nt][own]
                        du_writes[1, row - G, k[own] - G] += 1

                def edge(r):  # edge_term at this block's columns from D[r]
                    Dr = D[r]
                    cx = Dr[0][t + G + 2]
                    cx1 = Dr[0][t + G + 3]
                    for q in range(1, 6):
                        cx = cx + Dr[q][t + G + 2 - q]
                        cx1 = cx1 + Dr[q][t + G + 3 - q]
                    return (cx - cx1) * inv_h[1]

                # axis 0: the outputs y = b + 3 + m of each column, downwards
                for m in range(nr - 1, -1, -1):
                    y = b + G + m
                    pr = [at(P, b + m, k)] + pr[:6]
                    cz = [None] + cz[:6]
                    held = m >= nr - G
                    gv = hold[m - nr + G] if held else at(Gi, y, k)
                    uv = hold[m - nr + 2 * G] if held else at(U[0], y, k)
                    ok = kin & bool(_inside(torch.tensor(y), n0)) & (y >= i0 - G)
                    dm = [(pr[q + 1] - pr[q]) * inv_h[0] for q in range(6)]
                    ddm, dux = adjoint(dm, uv, gv)
                    ddm = [torch.where(ok, x, zero) for x in ddm]
                    if i0 <= y < i1 and ok.any():
                        if du is not None:
                            du[0][y - G, k[ok] - G] = dux[ok]
                        du_writes[0, y - G, k[ok] - G] += 1
                    cz[0] = ddm[0]
                    for q in range(1, 6):
                        cz[q] = cz[q] + ddm[q]
                    i = y + G
                    if i0 <= i < i1:
                        c0 = (cz[5] - cz[6]) * inv_h[0]
                        c1 = c1s[i]
                        kk = k[col]
                        if out is not None:
                            v = dP[i, kk] + 0.0
                        else:
                            inter = kin[col] & bool(_inside(torch.tensor(i), n0))
                            gi = Gi[i, kk]
                            v = torch.where(inter, beta * gi + 0.0, zero)
                            if daux is not None:
                                daux[i, kk] = torch.where(inter, alpha * gi, zero)
                        v = v + c0[col]
                        dP[i, kk] = v + c1[col]
                        writes[i, kk] += 1
                for r in range(nr):  # the step's rows' c_1, for the steps below
                    if b + r >= i0:
                        c1s[b + r] = edge(r)
                hold = [at(Gi, b + j, k) for j in range(G)] + [at(U[0], b + j, k)
                                                                for j in range(G)]
    return dP, du, daux, writes, du_writes


def per_plane_order(P, u, coeffs, aux, g, spacing, shape, where=None, out=None):
    """dP, du and daux in the order of one plane a block: each axis's edge
    cotangent c[z] = ddm_0(z + 2) + ddm_1(z + 1) + ... + ddm_5(z - 3) (0 for
    an output off the interior), then ``((beta*g + 0) + term_0) + term_1``."""
    alpha, beta, gamma = (float(c) for c in coeffs)
    gi = v2.unpack_padded(g, shape)
    vel = _velocity(u, spacing, shape, P, where)
    S = v2.padded_shape(shape)
    terms, du = [], []
    for ax in range(2):
        h = float(spacing[ax])
        _, ddm, dua = st.weno5_upwind_fwd_bwd(st.weno5_pair_diffs(P, ax, h, G, shape), vel[ax],
                                             -gamma * gi)
        du.append(dua)
        D = []
        for q in range(6):  # ddm_q on the padded layout, 3 more zeros either side
            z = torch.zeros(tuple(n + 2 * G for n in S), dtype=P.dtype)
            st.shift(z, (0, 0), 2 * G, shape).copy_(ddm[q])
            D.append(z)
        n, c = S[ax] + 1, None
        for q in range(6):
            sl = [slice(G, G + S[0]), slice(G, G + S[1])]
            sl[ax] = slice(G + 2 - q, G + 2 - q + n)
            c = D[q][tuple(sl)].clone() if c is None else c + D[q][tuple(sl)]
        terms.append((c.narrow(ax, 0, n - 1) - c.narrow(ax, 1, n - 1)) * (1.0 / h))
    inter = torch.zeros(S, dtype=torch.bool)
    v2.unpack_padded(inter, shape).fill_(True)
    if out is not None:
        base = out + 0.0
    else:
        b = torch.zeros_like(P)
        v2.unpack_padded(b, shape).copy_(beta * gi)
        base = torch.where(inter, b + 0.0, torch.zeros_like(P))
    daux = None
    if aux is not None and out is None:
        daux = torch.zeros_like(P)
        v2.unpack_padded(daux, shape).copy_(alpha * gi)
    return (base + terms[0]) + terms[1], tuple(du), daux


def _field(shape, bc, seed):
    rng = np.random.default_rng(seed)
    grid = T.Grid((0.0, 0.0), (1.0, 1.3), shape)
    phi = T.sample(shapes.zalesak_disk(), grid, bc, dtype=torch.float64, device="cpu")
    phi = phi.with_values(phi.values + 1e-3 * torch.from_numpy(rng.standard_normal(shape)))
    P = v2.pack_padded(phi.values, phi.bcs)
    A = v2.pack_padded(torch.from_numpy(rng.standard_normal(shape)), phi.bcs)
    gf = bwd.fold_ghost_cotangent_plain(
        torch.from_numpy(rng.standard_normal(v2.padded_shape(shape))), phi.bcs, shape)
    vel = 0.3 * torch.from_numpy(rng.standard_normal((2, *shape)))
    vel[1, :, ::4] = 0.0  # upwind ties
    s = 0.2 + 0.05 * torch.from_numpy(rng.standard_normal(shape))
    s[:, ::3] = 0.0
    out0 = torch.from_numpy(rng.standard_normal(v2.padded_shape(shape)))
    return phi, P, A, gf, vel, s, out0


#: (shape, nt, nr, chunk or None for the kernel's, bc): rows 2-3 (a grid has
#: at least 2 nodes an axis); a chunk and one row (a last chunk of one row);
#: a last step of one row; widths below the block's and one column past it;
#: the kernel's own sizes
MARCH_CASES = [
    ((2, 9), 8, 6, None, E(0)),
    ((2, 11), 8, 4, None, E(1)),
    ((3, 14), 16, 6, 4, E(1)),
    ((11, 10), 8, 6, 16, T.Periodic()),   # 17 padded rows: chunks 16, 1
    ((15, 3), 16, 4, 7, E(2)),            # 21 padded rows: 7, 7, 7; 9 columns < 16
    ((9, 11), 16, 6, 8, T.Symmetry()),    # 17 columns: the block's and one
    ((13, 13), 8, 4, 19, E(1)),           # 19 rows a chunk: the last step's 1 row
    ((65, 123), 128, 6, None, T.Periodic()),  # the kernel's: 2 chunks, 129 columns
]
MARCH_IDS = [f"{s[0]}x{s[1]}-nt{nt}-nr{nr}-c{c}" for s, nt, nr, c, _ in MARCH_CASES]


def _k3_velocities(phi, vel):
    """A streamed velocity (du written) and a program (none; the model takes
    its plain values, whichever way the kernel evaluates it)."""
    prog = lambda v: FusedStepper((T.AdvectionTerm(v),), phi, T.RK3()).entries[0][0].coef_static
    return {"stream": (vel[0].contiguous(), vel[1].contiguous()),
            "rotation": prog(shapes.rigid_rotation_velocity((0.5, 0.5), 1.0))}


@pytest.mark.parametrize("shape,nt,nr,chunk,bc", MARCH_CASES, ids=MARCH_IDS)
def test_k3_march_model_matches_per_plane_order(shape, nt, nr, chunk, bc):
    """The K3/K3″ 2D march, with and without aux and in accumulate mode: dP,
    du and daux bit for bit against the order of one plane a block; against
    the plain version dP to round-off, du and daux bit for bit; every dP and
    du element written once."""
    phi, P, A, gf, vel, _, out0 = _field(shape, bc, sum(shape) + nt + nr)
    sp = phi.spacing
    where = v2.Where((0.0, 0.0), None, 0.3)
    for name, u in _k3_velocities(phi, vel).items():
        for aux, coeffs in ((None, (0.0, 1.0, 0.03)), (A, (0.75, 0.25, 0.03))):
            dP, du, daux, writes, du_writes = k3_march_2d(P, u, coeffs, aux, gf, sp, shape,
                                                          where, nt=nt, nr=nr, chunk=chunk)
            fdP, fdu, fdaux = per_plane_order(P, u, coeffs, aux, gf, sp, shape, where)
            ref = bwd.stage_backward_plain(P, u, coeffs, aux, gf, sp, shape, where=where)
            assert bool((writes == 1).all()), (name, writes)
            assert bool((du_writes == 1).all()), name
            assert _bits_equal(dP, fdP), name
            assert _rel(dP, ref[0]) <= 1e-12, name
            if du is not None:
                for a, b, c in zip(du, fdu, ref[1]):
                    assert _bits_equal(a, b) and _bits_equal(a, c), name
            if aux is not None:
                assert _bits_equal(daux, fdaux) and _bits_equal(daux, ref[3]), name
        # accumulate mode: dP added to out (an advection term inside a term list)
        dP, _, _, writes, _ = k3_march_2d(P, u, (0.0, 1.0, 0.03), None, gf, sp, shape, where,
                                          out=out0.clone(), nt=nt, nr=nr, chunk=chunk)
        fdP, _, _ = per_plane_order(P, u, (0.0, 1.0, 0.03), None, gf, sp, shape, where,
                                    out=out0.clone())
        assert bool((writes == 1).all()) and _bits_equal(dP, fdP), name


# -- K3′ 2D ---------------------------------------------------------------------------


def _god_weight(dA, dB, sA, sB, h, k):
    """``godunov_weight``: what an output sends to P at offset ``k`` along
    an axis of spacing ``h`` from its pieces there."""
    inv_h, half_h, inv_hh = 1.0 / h, 0.5 * h, 1.0 / (h * h)
    w = {0: dA * inv_h - dB * inv_h, -1: -dA * inv_h, 1: dB * inv_h}.get(k, 0.0 * dA)
    cA = torch.where(sA == 1, bwd._d2_coef(-1, k), torch.where(sA == 2, bwd._d2_coef(0, k), 0.0))
    cB = torch.where(sB == 1, bwd._d2_coef(1, k), torch.where(sB == 2, bwd._d2_coef(0, k), 0.0))
    return w + dA * half_h * inv_hh * cA - dB * half_h * inv_hh * cB


def _pieces(P, terms, coeffs, g, spacing, shape, where):
    """Every interior output's pieces once (the staged twin's functions):
    Godunov (dA, dB, sA, sB per axis, dc) and curvature (dg, dhd, dhm), or
    None for a kind the list lacks."""
    gamma = float(coeffs[2])
    gbar = -gamma * v2.unpack_padded(g, shape)
    god, curv = [], []
    for spec, arrs in terms:
        if spec.kind == "advection":
            continue
        if spec.coef_kind == "program":
            vals, _ = bwd._program_coefs(spec, P, spacing, shape, where, False)
        else:
            vals = v2._coef_values(spec, arrs, P, spacing, shape, where)
        (curv if spec.kind == "curvature" else god).append((spec, vals[0] if vals else None))
    gp = cp = None
    if god:
        dA, dB, sA, sB, dc, _, _ = bwd._godunov_pieces(P, [s for s, _ in god],
                                                       [v for _, v in god], gbar, spacing, shape)
        gp = (dA, dB, sA, sB, dc)
    if curv:
        dg, dhd, dhm, _, _ = bwd._curvature_pieces(P, [v for _, v in curv], gbar, spacing, shape)
        cp = (dg, dhd, dhm)
    return gp, cp


def k3k_march_2d(P, terms, coeffs, aux, g, spacing, shape, where=None, nt=128, chunk=None):
    """The march of ``stage_bwd_terms_2d_kernel`` over the normal, curvature
    and eikonal terms (advection terms: K3's march in accumulate mode, as
    the wrapper): ``(dP, writes)``. A block of ``nt`` threads, one a
    column, owns the ``nt - 4`` columns of its threads 2 .. nt - 3."""
    n0, n1 = shape
    S0, S1 = n0 + 2 * G, n1 + 2 * G
    h = [float(x) for x in spacing]
    beta = float(coeffs[1])
    where = where or v2.Where()
    terms = v2.as_terms(terms)
    gp, cp = _pieces(P, terms, coeffs, g, spacing, shape, where)
    dtype = P.dtype
    dP = torch.zeros_like(P)
    writes = torch.zeros(P.shape, dtype=torch.int64)

    def padded(x):  # an interior-shaped piece on the padded layout, 0 elsewhere
        z = torch.zeros(P.shape, dtype=x.dtype)
        v2.unpack_padded(z, shape).copy_(x)
        return z

    god = None if gp is None else [[padded(x) for x in part] for part in gp[:4]] + [padded(gp[4])]
    cur = None if cp is None else [[padded(x) for x in part] for part in cp]
    chunk = chunk or _chunk_len(S0)
    for k0 in range(0, S1, nt - 4):
        k = k0 + torch.arange(nt - 4)  # the owned columns
        col = k < S1
        pos = k0 - 2 + torch.arange(nt)  # the threads' columns: the owned, a halo of 2
        for i0, i1 in _chunks(S0, chunk):
            acc = [torch.zeros(nt - 4, dtype=dtype) for _ in range(5)]  # rows s - 2 .. s + 2
            for s in range(i0 - 2, i1 + 2):
                acc = acc[1:] + [torch.zeros(nt - 4, dtype=dtype)]
                row_ok = 0 <= s < S0

                def piece(A, cols):  # A at (s, cols), from the block's positions only
                    idx = cols - (k0 - 2)
                    assert int(idx.min()) >= 0 and int(idx.max()) < nt
                    ok = (pos[idx] >= 0) & (pos[idx] < S1) & row_ok
                    return torch.where(ok, A[min(max(s, 0), S0 - 1)][pos[idx].clamp(0, S1 - 1)],
                                       torch.zeros((), dtype=A.dtype))

                # phase 1, this thread's own output: at its node, and along the march
                if god is not None:
                    dA, dB, sA, sB, dc = god
                    w = _god_weight(piece(dA[0], k), piece(dB[0], k), piece(sA[0], k),
                                    piece(sB[0], k), h[0], 0)
                    w = w + _god_weight(piece(dA[1], k), piece(dB[1], k), piece(sA[1], k),
                                        piece(sB[1], k), h[1], 0)
                    acc[2] = acc[2] + (w + piece(dc, k))
                    for kq in (-2, -1, 1, 2):
                        acc[2 + kq] = acc[2 + kq] + _god_weight(
                            piece(dA[0], k), piece(dB[0], k), piece(sA[0], k), piece(sB[0], k),
                            h[0], kq)
                if cur is not None:
                    dg, dhd, _ = cur
                    hh = piece(dhd[0], k) / (h[0] * h[0]) + piece(dhd[1], k) / (h[1] * h[1])
                    acc[2] = acc[2] - 2.0 * hh
                    d0, dh0 = piece(dg[0], k) / (2.0 * h[0]), piece(dhd[0], k) / (h[0] * h[0])
                    acc[3] = acc[3] + (d0 + dh0)
                    acc[1] = acc[1] + (-d0 + dh0)
                # phase 2: the gather along the row and across the mixed edges
                for kk in (-2, -1, 1, 2):
                    if god is not None:
                        c = k - kk
                        acc[2] = acc[2] + _god_weight(piece(dA[1], c), piece(dB[1], c),
                                                      piece(sA[1], c), piece(sB[1], c), h[1], kk)
                    if cur is not None and abs(kk) == 1:
                        c = k - kk
                        dgv = piece(dg[1], c) / (2.0 * h[1])
                        acc[2] = acc[2] + ((dgv if kk == 1 else -dgv)
                                           + piece(dhd[1], c) / (h[1] * h[1]))
                if cur is not None:
                    for sa in (-1, 1):
                        for sb in (-1, 1):
                            w = piece(cur[2][0], k - sb) / (4.0 * h[0] * h[1])
                            acc[2 + sa] = acc[2 + sa] + (w if sa * sb > 0 else -w)
                i = s - 2
                if i0 <= i < i1:
                    kk = k[col]
                    v = acc[0][col]
                    inter = _inside(kk, n1) & bool(_inside(torch.tensor(i), n0))
                    v = torch.where(inter, beta * g[i, kk] + v, v)
                    dP[i, kk] = v
                    writes[i, kk] += 1
    for spec, arrs in terms:  # an advection term's share: K3's march, accumulate mode
        if spec.kind == "advection":
            u = spec.coef_static if spec.coef_kind == "program" else arrs
            dP = k3_march_2d(P, u, coeffs, None, g, spacing, shape, where, out=dP, nt=nt,
                             chunk=chunk)[0]
    return dP, writes


K3K_LISTS = {
    "config 4": lambda mf, s, vel: (T.CurvatureTerm(-0.05), T.NormalMotionTerm(mf(s))),
    "eikonal none": lambda mf, s, vel: (T.EikonalReinitializationTerm(),),
    "eikonal frozen": lambda mf, s, vel: (T.EikonalReinitializationTerm(mf(s)),),
    "program + dt": lambda mf, s, vel: (
        T.NormalMotionTerm(lambda xs, t: 0.1 + 0.05 * xs[0] + 0.02 * t * xs[1]),
        T.CurvatureTerm(mf(s))),
    "advection + normal": lambda mf, s, vel: (T.AdvectionTerm(mf(vel)), T.NormalMotionTerm(mf(s))),
}

K3K_SHAPES = [
    ((3, 14), 16, 4, E(1)),
    ((11, 10), 8, 16, T.Periodic()),   # 17 padded rows: chunks 16, 1
    ((9, 7), 16, 5, T.Symmetry()),     # 13 columns: the block's 12 and one
    ((13, 12), 8, None, E(2)),
]
#: every list at the small sizes; at the kernel's (2 chunks, 125 columns: its
#: block's 124 and one) the two that take its every branch (Godunov and
#: curvature pieces; K3 after)
K3K_CASES = [(*c, name) for c in K3K_SHAPES for name in K3K_LISTS] + [
    ((65, 119), 128, None, E(1), name) for name in ("config 4", "advection + normal")]


@pytest.mark.parametrize("shape,nt,chunk,bc,name", K3K_CASES,
                         ids=[f"{s[0]}x{s[1]}-nt{nt}-c{c}-{n}" for s, nt, c, _, n in K3K_CASES])
def test_k3k_march_model_matches_staged(shape, nt, chunk, bc, name):
    """The K3′ 2D march over a term list: dP against the staged twin (and the
    plain version) to round-off in float64, every element written once."""
    phi, P, _, gf, vel, s, _ = _field(shape, bc, sum(shape) + nt + len(name))
    mf = lambda x: T.MeshField(x, phi.grid)
    entries = FusedStepper(K3K_LISTS[name](mf, s, vel), phi, T.RK3()).entries
    where = v2.Where((0.0, 0.0), None, 0.3)
    coeffs = (0.0, 1.0, 0.03)
    dP, writes = k3k_march_2d(P, entries, coeffs, None, gf, phi.spacing, shape, where, nt=nt,
                              chunk=chunk)
    staged = bwd.stage_backward_terms_staged(P, entries, coeffs, None, gf, phi.spacing, shape,
                                             where=where)[0]
    plain = bwd.stage_backward_terms_plain(P, entries, coeffs, None, gf, phi.spacing, shape,
                                           where=where)[0]
    assert bool((writes == 1).all())
    assert _rel(dP, staged) <= 1e-12
    assert _rel(dP, plain) <= 1e-10
