"""K7's one-launch design on the CPU: a torch model of what its gated kernels
(``csrc/refresh_ghosts.cu`` ``band_refresh_3d_kernel`` and
``band_refresh_2d_kernel``) write, held bit for bit against
``refresh_band_ghosts_plain``, the version the kernels are compared with on
the card.

The model decodes each thread index of a gate's work with the kernels' index
math (the 3D kernel: K2's classes E, A, B, C under (1, 1); K2's threads of
the edge ghosts of axes 0 and 1 at an interior axis-2 index, then A and B,
under (1, 0); one
axis-2 slot of every padded row under (0, 1); the 2D kernel: K2's 2D threads,
the axis-0 ones alone under (1, 0), the axis-1 ones alone under (0, 1)) and
gives each written ghost the value its rule takes: under (1, 1) and (1, 0)
the composition recomputed from the interior, under (0, 1) the ghost of the
row's stored nodes (the axis-0/1 ghosts as they stand). The grid-stride loop
of a grid of any size visits each thread index once. Every gated ghost is
written once and nothing else; (0, 0) writes nothing.

Inputs are made from seeds with numpy; the shells are scribbled, so a ghost
that recomputed what it should read (or the reverse) shows.
"""

import numpy as np
import pytest
import torch

import lsm_tpu_torch as T
from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import weno_v2 as tv2

from test_torch_ghost_shells import _cases

G = tv2.GHOST
FLAGS = [(0, 0), (1, 0), (0, 1), (1, 1)]
FLAG_IDS = [f"flags{a}{b}" for a, b in FLAGS]
DTYPES = [torch.float32, torch.float64]
SHAPES_3D = [(4, 5, 6), (8, 9, 10), (9, 12, 7)]
SHAPES_2D = [(5, 7), (8, 11), (13, 9)]


def _cases_nd(ndim):
    return [(name, tuple(bcs)[:ndim], least) for name, bcs, least in _cases()]


def _ids(cases):
    return [f"{'x'.join(map(str, s))}-{n}" for s, n, _ in cases]


CASES_3D = [(s, n, b) for s in SHAPES_3D for n, b, least in _cases_nd(3) if min(s) >= least]
CASES_2D = [(s, n, b) for s in SHAPES_2D for n, b, least in _cases_nd(2) if min(s) >= least]


def _args(bcs, shape):
    kinds, degrees, weights = tv2._ghost_args(bcs, shape)
    w = np.asarray(weights[:]).reshape(3, 2, G, 8)  # [axis][side][k-1][j] (3 axes always)
    return list(kinds), list(degrees), w


def _ghost_of(kinds, degrees, w, axis, side, k, n, node, like):
    """The kernels' ``ghost_of``: the ghost at distance ``k`` on ``side`` from
    the line's nodes ``node(m)``, in their arithmetic (``0 + w0 x0 + ...``)."""
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


def _axis_ghosts(f, args, axis, n):
    """``f`` with axis ``axis`` padded by its ghosts, each from ``f``'s line
    through it (the other axes as ``f`` has them)."""
    kinds, degrees, w = args
    layers = []
    for p in range(n + 2 * G):
        if G <= p < G + n:
            layers.append(f.narrow(axis, p - G, 1))
            continue
        side, k = (0, G - p) if p < G else (1, p - n - 2)
        layers.append(_ghost_of(kinds, degrees, w, axis, side, k, n,
                                lambda m: f.narrow(axis, m, 1), f))
    return torch.cat(layers, dim=axis)


def recomputed(Q, bcs, shape):
    """Every ghost from the interior alone, through the composition f0, f1
    (, f2): what a thread of (1, 1) or (1, 0) writes."""
    args = _args(bcs, shape)
    f = tv2.unpack_padded(Q, shape).clone()
    for axis, n in enumerate(shape):
        f = _axis_ghosts(f, args, axis, n)
    return f


def from_stored_rows(Q, bcs, shape):
    """The last axis's ghosts of every padded row from the row's stored nodes:
    what a thread of (0, 1) writes (the earlier axes' ghosts as they stand)."""
    last = len(shape) - 1
    rows = Q.narrow(last, G, shape[last])
    return _axis_ghosts(rows, _args(bcs, shape), last, shape[last])


def _pos(g, n):
    """Padded index of ghost slot ``g`` in [0, 6) of an axis of ``n`` nodes."""
    return torch.where(g < G, g, n + g)


def threads_3d(shape, gate):
    """``(thread index, flat position, rule)`` of every ghost a 3D launch
    writes under ``gate`` (bit 0 flags[0], bit 1 flags[1]); rule 0 recomputes
    from the interior, 1 reads the stored row."""
    n0, n1, n2 = shape
    S1, S2 = n1 + 2 * G, n2 + 2 * G
    at = lambda i, j, k: (i * S1 + j) * S2 + k
    cnt_e1, cnt_e2, cnt_e3 = 36 * S2, 36 * n1, 36 * n0
    cnt_a, cnt_b, cnt_c = n1 * n2, n0 * n2, 6 * n0 * n1
    cnt_e = cnt_e1 + cnt_e2 + cnt_e3
    g6 = torch.arange(6)

    def k2(t):  # K2's thread t: its positions, one row per thread (-1: none)
        out = torch.full((t.numel(), 6), -1, dtype=torch.long)
        e = t < cnt_e
        e1, e2 = t < cnt_e1, (t >= cnt_e1) & (t < cnt_e1 + cnt_e2)
        u = t[e1]
        r = u // S2
        out[e1, 0] = at(_pos(r // 6, n0), _pos(r % 6, n1), u % S2)
        u = t[e2] - cnt_e1
        r = u // 6
        out[e2, 0] = at(_pos(r // n1, n0), G + r % n1, _pos(u % 6, n2))
        e3 = e & ~e1 & ~e2
        u = t[e3] - cnt_e1 - cnt_e2
        r = u // 6
        out[e3, 0] = at(G + r // 6, _pos(r % 6, n1), _pos(u % 6, n2))
        u = t - cnt_e
        a = (u >= 0) & (u < cnt_a)
        v = u[a]
        out[a] = at(_pos(g6, n0)[None], (G + v // n2)[:, None], (G + v % n2)[:, None])
        b = (u >= cnt_a) & (u < cnt_a + cnt_b)
        v = u[b] - cnt_a
        out[b] = at((G + v // n2)[:, None], _pos(g6, n1)[None], (G + v % n2)[:, None])
        c = (u >= cnt_a + cnt_b) & (u < cnt_a + cnt_b + cnt_c)
        v = u[c] - cnt_a - cnt_b
        r = v // 6
        out[c, 0] = at(G + r // n1, G + r % n1, _pos(v % 6, n2))
        return out

    if gate == 0:
        t = torch.arange(0)
        return t, torch.full((0, 6), -1, dtype=torch.long), 0
    if gate == 3:
        t = torch.arange(cnt_e + cnt_a + cnt_b + cnt_c)
        return t, k2(t), 0
    if gate == 1:  # K2's thread of an i and j ghost at interior k, then A's and B's
        e01 = 36 * n2
        t = torch.arange(e01 + cnt_a + cnt_b)
        u = torch.where(t < e01, t // n2 * S2 + G + t % n2, cnt_e + t - e01)
        return t, k2(u), 0
    t = torch.arange(6 * (n0 + 2 * G) * S1)
    out = torch.full((t.numel(), 6), -1, dtype=torch.long)
    r = t // 6
    out[:, 0] = at(r // S1, r % S1, _pos(t % 6, n2))
    return t, out, 1


def threads_2d(shape, gate):
    """The 2D launch's threads under ``gate``, as :func:`threads_3d`: [0, 6
    n1) an axis-0 ghost of an interior column, then 6 (n0+6) an axis-1 slot
    of a padded row; (1, 0) the first range, (0, 1) the second reading the
    stored rows, (1, 1) both recomputing."""
    n0, n1 = shape
    S1 = n1 + 2 * G
    cols, rows = 6 * n1, 6 * (n0 + 2 * G)
    lo, hi = {0: (0, 0), 1: (0, cols), 2: (cols, cols + rows), 3: (0, cols + rows)}[gate]
    t = torch.arange(lo, hi)
    out = torch.full((t.numel(), 1), -1, dtype=torch.long)
    c = t < cols
    out[c, 0] = _pos(t[c] // n1, n0) * S1 + G + t[c] % n1
    r = t[~c] - cols
    out[~c, 0] = (r // 6) * S1 + _pos(r % 6, n1)
    return t, out, 1 if gate == 2 else 0


def gated_model(Q, bcs, shape, flags):
    """The launch under ``flags``: each thread's ghosts written with its rule."""
    gate = int(flags[0] != 0) | int(flags[1] != 0) << 1
    _, pos, rule = (threads_3d if len(shape) == 3 else threads_2d)(shape, gate)
    vals = (from_stored_rows if rule else recomputed)(Q, bcs, shape).reshape(-1)
    out = Q.clone()
    p = pos[pos >= 0]
    out.view(-1)[p] = vals[p]
    return out


def _scribbled(shape, bcs, dtype, seed):
    """A packed buffer whose shells are then overwritten with random values."""
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    Q = tv2.pack_padded(vals, bcs)
    shell = torch.ones_like(Q, dtype=torch.bool)
    tv2.unpack_padded(shell, shape).fill_(False)
    Q[shell] = torch.from_numpy(rng.standard_normal(int(shell.sum()))).to(dtype)
    return Q


def _bits(x):
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _check_model(shape, name, bcs, dtype, flags):
    Q = _scribbled(shape, bcs, dtype, seed=sum(shape) * 11 + len(name) + 3 * sum(flags))
    f = torch.tensor(flags, dtype=torch.int32)
    ref = bd.refresh_band_ghosts_plain(Q.clone(), bcs, shape, f)
    got = gated_model(Q, bcs, shape, flags)
    assert torch.equal(_bits(got), _bits(ref))
    if flags == (0, 0):
        assert torch.equal(_bits(got), _bits(Q))
    # the wrapper on the CPU runs the plain version
    assert torch.equal(_bits(bd.refresh_band_ghosts_fast(Q.clone(), bcs, shape, f)), _bits(ref))


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape,name,bcs", CASES_3D, ids=_ids(CASES_3D))
def test_gated_model_3d_matches_plain(shape, name, bcs, dtype, flags):
    _check_model(shape, name, bcs, dtype, flags)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape,name,bcs", CASES_2D, ids=_ids(CASES_2D))
def test_gated_model_2d_matches_plain(shape, name, bcs, dtype, flags):
    _check_model(shape, name, bcs, dtype, flags)


def _gated_ghosts(shape, flags):
    """The ghosts the plain version writes under ``flags``: 3D, flags[0] those
    at an interior last-axis index, flags[1] the last axis's shells (the
    whole padded extent of the earlier axes); 2D the same with axis 1 last."""
    ghost = torch.ones(tv2.padded_shape(shape), dtype=torch.bool)
    tv2.unpack_padded(ghost, shape).fill_(False)
    last = len(shape) - 1
    inner = torch.zeros_like(ghost)
    inner.narrow(last, G, shape[last]).fill_(True)
    return ghost & ((inner & bool(flags[0])) | (~inner & bool(flags[1])))


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("shape", SHAPES_3D + [(1, 7, 5), (4, 37, 75), (67, 4, 9)]
                         + SHAPES_2D + [(1, 9), (67, 131), (4, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gated_threads_write_each_gated_ghost_once(shape, flags):
    gate = int(flags[0]) | int(flags[1]) << 1
    t, pos, _ = (threads_3d if len(shape) == 3 else threads_2d)(shape, gate)
    written = torch.bincount(pos[pos >= 0], minlength=int(np.prod(tv2.padded_shape(shape))))
    assert torch.equal(written, _gated_ghosts(shape, flags).reshape(-1).long())
    # the grid-stride loop: a grid of any size visits each thread index once
    total = t.numel()
    for blocks in (1, 3, max(1, -(-total // 256))):
        stride = blocks * 256
        seen = torch.cat([torch.arange(first, total, stride)
                          for first in range(min(stride, total))]) if total else t
        assert torch.equal(torch.sort(seen).values, torch.arange(total))


def test_gated_counts_fit_the_full_launch():
    """The gated work of (1, 0) and (0, 1) never exceeds (1, 1)'s, the count
    the 3D launch checks against 32-bit indices."""
    for shape in SHAPES_3D + [(512, 512, 512), (1, 7, 5), (4, 37, 75)]:
        n = [threads_3d(shape, g)[0].numel() if max(shape) < 100 else None for g in (1, 2, 3)]
        n0, n1, n2 = shape
        full = 36 * (n2 + 6) + 36 * n1 + 36 * n0 + n1 * n2 + n0 * n2 + 6 * n0 * n1
        f01, f2 = 36 * n2 + n1 * n2 + n0 * n2, 6 * (n0 + 6) * (n1 + 6)
        assert f01 <= full and f2 <= full
        if n[0] is not None:
            assert n == [f01, f2, full]


def test_gated_refresh_checks_its_flags():
    shape = (8, 9, 10)
    bcs = T.normalize_bcs(T.Periodic(), 3)
    Q = _scribbled(shape, bcs, torch.float32, seed=1)
    for bad in (torch.ones(2, dtype=torch.int64), torch.ones(3, dtype=torch.int32),
                torch.ones(4, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="flags"):
            bd.refresh_band_ghosts_fast(Q, bcs, shape, bad)
    assert bd.refresh_band_ghosts_fast.launches == 0
