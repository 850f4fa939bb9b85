"""The ghost-shell pair's designs on the CPU: torch models of what K4
(``csrc/fold_ghosts.cu``, the fold as a gather, out of place) and K2's 3D
entry (``csrc/refresh_ghosts.cu``, one launch) compute, held bit for bit
against the plain versions the kernels are compared with on the card.

- K4: each interior node gathers, in the plain scatter's order (axis 2's
  pass, then axis 1's, then axis 0's; side 0 k = 1..3, then side 1), the
  products ``w * ghost`` its sources would receive, where a ghost of axis 1
  or 0 passes on its partial sum from the earlier passes (V2, then V1).
- K2: each ghost is recomputed from the interior alone through the
  composition axis 0, 1, 2, with the kernel's arithmetic (``0 + w0 x0 +
  ...``); the kernel's threads (one an edge or vertex ghost, then the
  ghosts of one line) cover every ghost once.
- K4's wrapper on the CPU returns a new buffer with zero shells and leaves
  its argument's bits alone; the kernel's flat bulk copy holds only nodes
  that gather nothing.

Inputs are made from seeds with numpy. The models read the kernels'
arguments (``weno_v2._ghost_args``: BC codes, degrees, float64 weights cast to
the field's dtype).
"""

import numpy as np
import pytest
import torch

import lsm_tpu_torch as T
from lsm_tpu_torch.ops import weno_v2 as tv2
from lsm_tpu_torch.ops import weno_v2_bwd as tbwd

G = tv2.GHOST


def _cases():
    """The smoke's five BC cases, per-side mixes, and ``Extrapolation(7)`` on an
    8-node axis: ``(name, bcs, least nodes an axis needs)``."""
    E = T.Extrapolation
    return [
        ("periodic", T.normalize_bcs(T.Periodic(), 3), 4),
        ("symmetry", T.normalize_bcs(T.Symmetry(), 3), 4),
        ("extrap0", T.normalize_bcs(E(0), 3), 4),
        ("extrap2", T.normalize_bcs(E(2), 3), 4),
        ("mixed", T.normalize_bcs([(T.Symmetry(), E(1)), T.Periodic(), (E(3), T.Symmetry())], 3),
         4),
        ("sides", T.normalize_bcs([(E(1), E(2)), (T.Symmetry(), E(0)), (E(3), T.Symmetry())], 3),
         4),
        ("mixed7", T.normalize_bcs([(E(7), T.Symmetry()), T.Periodic(), (T.Symmetry(), E(5))], 3),
         8),
        ("extrap7", T.normalize_bcs(E(7), 3), 8),
    ]


SHAPES = [(4, 5, 6), (8, 9, 10), (10, 12, 14)]
CASES = [(shape, name, bcs) for shape in SHAPES for name, bcs, least in _cases()
         if min(shape) >= least]
IDS = [f"{'x'.join(map(str, s))}-{n}" for s, n, _ in CASES]
DTYPES = [torch.float32, torch.float64]


def _args(bcs, shape):
    kinds, degrees, weights = tv2._ghost_args(bcs, shape)
    w = np.asarray(weights[:]).reshape(3, 2, G, 8)  # [axis][side][k-1][j]
    return list(kinds), list(degrees), w


def _gpos(side, k, n):
    """Padded index of the ghost at distance ``k`` on ``side``."""
    return G - k if side == 0 else G + n - 1 + k


def _receivers(kinds, degrees, w, axis, n, dtype):
    """K4's ``weight_of`` over one axis: ``(side, k, mask, weight)`` per ghost in
    the gather's order; ``mask[m]`` when interior node m is one of the ghost's
    sources, ``weight[m]`` its weight in ``dtype``."""
    out = []
    for side in (0, 1):
        kind, P = kinds[2 * axis + side], degrees[2 * axis + side]
        for k in range(1, G + 1):
            mask, wt = np.zeros(n, bool), np.zeros(n)
            for m in range(n):
                if kind == 0:
                    mask[m], wt[m] = m == (n - 1 - k if side == 0 else k), 1.0
                elif kind == 1:
                    mask[m], wt[m] = m == (k if side == 0 else n - 1 - k), 1.0
                else:
                    j = m if side == 0 else n - 1 - m
                    if j <= P:
                        mask[m], wt[m] = True, w[axis, side, k - 1, j]
            out.append((side, k, torch.from_numpy(mask), torch.tensor(wt, dtype=dtype)))
    return out


def fold_gather_model(g, bcs, shape):
    """K4 as a gather: V2 = g + axis 2's contributions (every row, interior k),
    V1 = V2 + w * V2(ghost) over axis 1 (interior j and k), the interior of
    the result = V1 + w * V1(ghost) over axis 0; the shells 0."""
    kinds, degrees, w = _args(bcs, shape)
    n0, n1, n2 = shape
    v = g[:, :, G:G + n2].clone()
    for side, k, mask, wt in _receivers(kinds, degrees, w, 2, n2, g.dtype):
        p = _gpos(side, k, n2)
        v = torch.where(mask, v + wt * g[:, :, p:p + 1], v)
    u = v[:, G:G + n1, :].clone()
    for side, k, mask, wt in _receivers(kinds, degrees, w, 1, n1, g.dtype):
        p = _gpos(side, k, n1)
        u = torch.where(mask[:, None], u + wt[:, None] * v[:, p:p + 1, :], u)
    x = u[G:G + n0].clone()
    for side, k, mask, wt in _receivers(kinds, degrees, w, 0, n0, g.dtype):
        p = _gpos(side, k, n0)
        x = torch.where(mask[:, None, None], x + wt[:, None, None] * u[p:p + 1], x)
    out = torch.zeros_like(g)
    tv2.unpack_padded(out, shape).copy_(x)
    return out


def _ghost_of(kinds, degrees, w, axis, side, k, n, node, like):
    """K2's ``ghost_of``: the ghost at distance ``k`` on ``side`` from the
    line's nodes ``node(m)``, with the kernel's arithmetic."""
    kind = kinds[2 * axis + side]
    if kind == 0:
        return node(n - 1 - k if side == 0 else k)
    if kind == 1:
        return node(k if side == 0 else n - 1 - k)
    m0, step = (0, 1) if side == 0 else (n - 1, -1)
    ws = torch.tensor(w[axis, side, k - 1], dtype=like.dtype)
    val = torch.zeros_like(node(m0)) + ws[0] * node(m0)
    for j in range(1, degrees[2 * axis + side] + 1):
        val = val + ws[j] * node(m0 + j * step)
    return val


def refresh_model(P, bcs, shape):
    """K2's one launch: every ghost from the interior alone, through the
    composition f0 (axis 0 over the interior), f1 (axis 1 over f0), f2 (axis
    2 over f1); the interior left as it is."""
    kinds, degrees, w = _args(bcs, shape)
    interior = tv2.unpack_padded(P, shape).clone()
    f = interior
    for axis, n in enumerate(shape):
        layers = []
        for p in range(n + 2 * G):
            if G <= p < G + n:
                layers.append(f.narrow(axis, p - G, 1))
                continue
            side, k = (0, G - p) if p < G else (1, p - n - 2)
            layers.append(_ghost_of(kinds, degrees, w, axis, side, k, n,
                                    lambda m: f.narrow(axis, m, 1), P))
        f = torch.cat(layers, dim=axis)
    out = P.clone()
    shell = torch.ones_like(P, dtype=torch.bool)
    tv2.unpack_padded(shell, shape).fill_(False)
    out[shell] = f[shell]
    return out


def _scribbled(shape, bcs, dtype, seed):
    """``(pack_padded(values), the same with random shells)``."""
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    P = tv2.pack_padded(vals, bcs)
    Q = P.clone()
    shell = torch.ones_like(P, dtype=torch.bool)
    tv2.unpack_padded(shell, shape).fill_(False)
    Q[shell] = torch.from_numpy(rng.standard_normal(int(shell.sum()))).to(dtype)
    return P, Q


def _bits(x):
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape,name,bcs", CASES, ids=IDS)
def test_fold_gather_model_matches_plain_scatter(shape, name, bcs, dtype):
    rng = np.random.default_rng(sum(shape) + len(name))
    g = torch.from_numpy(rng.standard_normal(tv2.padded_shape(shape))).to(dtype)
    ref = tbwd.fold_ghost_cotangent_plain(g.clone(), bcs, shape)
    got = fold_gather_model(g, bcs, shape)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape,name,bcs", CASES, ids=IDS)
def test_refresh_model_matches_plain_and_pad_ghost(shape, name, bcs, dtype):
    P, Q = _scribbled(shape, bcs, dtype, seed=sum(shape) * 7 + len(name))
    got = refresh_model(Q, bcs, shape)
    assert torch.equal(got, tv2.refresh_ghosts_plain(Q.clone(), bcs, shape))
    assert torch.equal(got, P)


@pytest.mark.parametrize("shape", SHAPES + [(1, 7, 5), (4, 37, 75), (67, 4, 9)],
                         ids=lambda s: "x".join(map(str, s)))
def test_refresh_threads_cover_every_ghost_once(shape):
    """The kernel's threads: one a ghost of two or three axes (i and j
    ghosts, any k; i and k ghosts; j and k ghosts), then one the six axis-0
    ghosts of an interior column, one the six axis-1 ghosts of an interior
    (i, k), and one an axis-2 ghost of an interior row."""
    n0, n1, n2 = shape
    S1, S2 = n1 + 2 * G, n2 + 2 * G
    at = lambda i, j, k: (i * S1 + j) * S2 + k
    pos = lambda g, n: torch.where(g < G, g, n + g)
    t = torch.arange(36 * S2)
    r = t // S2
    e1 = at(pos(r // 6, n0), pos(r % 6, n1), t % S2)
    t = torch.arange(36 * n1)
    r = t // 6
    e2 = at(pos(r // n1, n0), G + r % n1, pos(t % 6, n2))
    t = torch.arange(36 * n0)
    r = t // 6
    e3 = at(G + r // 6, pos(r % 6, n1), pos(t % 6, n2))
    g = torch.arange(6)
    t = torch.arange(n1 * n2)
    a = at(pos(g, n0)[:, None], (G + t // n2)[None], (G + t % n2)[None])
    t = torch.arange(n0 * n2)
    b = at((G + t // n2)[None], pos(g, n1)[:, None], (G + t % n2)[None])
    t = torch.arange(n0 * n1 * 6)
    r = t // 6
    c = at(G + r // n1, G + r % n1, pos(t % 6, n2))
    written = torch.bincount(torch.cat([x.reshape(-1) for x in (e1, e2, e3, a, b, c)]),
                             minlength=(n0 + 2 * G) * S1 * S2)
    shell = torch.ones(tv2.padded_shape(shape), dtype=torch.bool)
    tv2.unpack_padded(shell, shape).fill_(False)
    assert torch.equal(written, shell.reshape(-1).long())


def _bulk(bcs, shape):
    """K4's bulk: per axis the padded range [lo, hi) of nodes farther than
    max(4, P + 1) from both faces."""
    kinds, degrees, _ = _args(bcs, shape)
    reach = [max([G + 1] + [degrees[2 * a + s] + 1 for s in (0, 1) if kinds[2 * a + s] == 2])
             for a in range(3)]
    lo = [G + e for e in reach]
    return lo, [max(G + n - e, l) for n, e, l in zip(shape, reach, lo)]


@pytest.mark.parametrize("name", ["periodic", "mixed7"])
@pytest.mark.parametrize("shape", [(8, 9, 10), (18, 17, 30), (30, 12, 21)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fold_threads_cover_every_node_once(shape, name):
    """K4's two parts: the flat pass writes the ghosts and the nodes of the
    bulk rows (i and j in the bulk's ranges); the other threads, one a node,
    the interior nodes of the strip rows: the planes outside the bulk's axis-0
    range, then the rows outside its axis-1 range in the planes within it."""
    bcs = dict((n, b) for n, b, _ in _cases())[name]
    lo, hi = _bulk(bcs, shape)
    n0, n1, n2 = shape
    S = tv2.padded_shape(shape)
    i, j = torch.meshgrid(torch.arange(S[0]), torch.arange(S[1]), indexing="ij")
    interior = torch.zeros(S, dtype=torch.bool)
    tv2.unpack_padded(interior, shape).fill_(True)
    bulk_row = ((i >= lo[0]) & (i < hi[0]) & (j >= lo[1]) & (j < hi[1]))[:, :, None]
    flat = ~interior | bulk_row.expand(S)
    B0, B1, lo0, lo1 = hi[0] - lo[0], hi[1] - lo[1], lo[0] - G, lo[1] - G
    t = torch.arange((n0 - B0) * n1 * n2)
    row, mk = t // n2, t % n2
    p, mj = row // n1, row % n1
    planes = ((G + torch.where(p < lo0, p, p + B0)) * S[1] + G + mj) * S[2] + G + mk
    t = torch.arange(B0 * (n1 - B1) * n2)
    q, mk = t // n2, t % n2
    ii, jj = q // (n1 - B1), q % (n1 - B1)
    rows = ((G + lo0 + ii) * S[1] + G + torch.where(jj < lo1, jj, jj + B1)) * S[2] + G + mk
    written = flat.reshape(-1).long() + torch.bincount(torch.cat([planes, rows]),
                                                       minlength=flat.numel())
    assert torch.equal(written, torch.ones_like(written))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_fold_fast_on_cpu_returns_a_new_buffer(dtype):
    shape = (8, 9, 10)
    for name, bcs, least in _cases():
        rng = np.random.default_rng(least + len(name))
        g = torch.from_numpy(rng.standard_normal(tv2.padded_shape(shape))).to(dtype)
        before = _bits(g).clone()
        out = tbwd.fold_ghost_cotangent_fast(g, bcs, shape)
        assert out is not g and out.data_ptr() != g.data_ptr() and out.is_contiguous()
        assert torch.equal(_bits(g), before)
        assert torch.equal(out, tbwd.fold_ghost_cotangent_plain(g.clone(), bcs, shape))
        shell = torch.ones_like(out, dtype=torch.bool)
        tv2.unpack_padded(shell, shape).fill_(False)
        assert not out[shell].any()
    assert tbwd.fold_ghost_cotangent_fast.launches == 0


@pytest.mark.parametrize("name", ["periodic", "mixed7"])
def test_fold_bulk_vectors_gather_nothing(name):
    """K4's flat copy: a 16-byte vector of four floats whose first node
    (i, j, k) has i and j in [3 + E, 3 + n - E) and k..k+3 there too (E =
    max(4, P + 1) on each axis) is copied as it is; the gather leaves every
    node of such a vector equal to g."""
    shape = (18, 17, 30)
    bcs = dict((n, b) for n, b, _ in _cases())[name]
    lo, hi = _bulk(bcs, shape)
    S = tv2.padded_shape(shape)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(S)).float()
    gf = fold_gather_model(g, bcs, shape)
    first = torch.arange(0, g.numel() - 3, 4)
    i, j, k = first // (S[1] * S[2]), first // S[2] % S[1], first % S[2]
    bulk = ((i >= lo[0]) & (i < hi[0]) & (j >= lo[1]) & (j < hi[1]) & (k >= lo[2])
            & (k + 4 <= hi[2]))
    assert bool(bulk.any())
    nodes = (first[bulk][:, None] + torch.arange(4)).reshape(-1)
    assert torch.equal(gf.reshape(-1)[nodes], g.reshape(-1)[nodes])
    assert bool((g.reshape(-1)[nodes] != 0).all())
