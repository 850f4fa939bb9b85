"""The thread maps of K5 and K2's single-axis entry on the CPU: numpy models of
what each thread of ``csrc/fold_ghosts.cu`` ``zero_shells_kernel`` and
``csrc/refresh_ghosts.cu`` ``refresh_axis_kernel`` writes, held bit for bit
against ``zero_pad_shells_plain`` and ``refresh_axis_plain``, the versions the
kernels are compared with on the card.

- K5 reads the padded buffer as flat memory: the shells are the gaps between
  the interior rows. Block b zeroes the seams of seam block b (the
  six-element seams between two rows of a plane, a few lanes each) and
  chunk b of the long gaps (head, tail, between two planes: a block's
  16-byte vectors, scalars at the unaligned ends). The model decodes every block and
  thread as the kernel does (its constants read from the source) and checks
  that every shell node is
  written once, no interior node at all, and every vector store is 16-byte
  aligned, for buffers on and off 16-byte alignment.
- K2's single-axis phase: axes 0 and 1 a thread a line and its six ghosts
  (lines at (j, k) or (i, k), k fastest), the line decoded with a 32-bit
  fast division below the block's first line; axis 2 a lane a ghost, six
  lanes the contiguous seam between two padded rows' ends. The
  model writes each ghost with the kernel's arithmetic (``0 + w0 x0 + ...``,
  each product and sum rounded) from values read before any write, checks
  that no thread writes what another reads, and runs the three phases in
  order under K7's gates (the route of K2's 3D entry and of K7 past 32-bit
  indices).
- A buffer past 2^31 elements is decoded (not allocated): a few thread
  indices against the layout's direct formula.
- JAX's ``_zero_pad_shells`` (Pallas in interpret mode, JAX's layout) and the
  port's K5 leave the same interior and zero shells.

Inputs are made from seeds with numpy; the shells are scribbled.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu_torch as T
from lsm_tpu.ops import weno_v2_bwd as jbwd
from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import weno_v2 as tv2
from lsm_tpu_torch.ops import weno_v2_bwd as tbwd

from test_torch_ghost_shells import _cases

G = tv2.GHOST
CSRC = Path(tbwd.__file__).resolve().parent.parent / "csrc"
DTYPES = [torch.float32, torch.float64]


def _const(source, name):
    """The value of ``constexpr int name = ...;`` in ``csrc/source``."""
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


THREADS = _const("fold_ghosts.cu", "kThreads")
ZERO_VECTORS = _const("fold_ghosts.cu", "kZeroVectors")
SEAM_LANES = _const("fold_ghosts.cu", "kSeamLanes")
SEAMS = _const("fold_ghosts.cu", "kSeams")
AXIS_THREADS = _const("refresh_ghosts.cu", "kThreads")
U32 = 1 << 32


def fast_div(d):
    """``fast_div``'s ``(d, mul, shr)``."""
    if d <= 1:
        return (d, 0, 0)
    l = (d - 1).bit_length()
    return (d, ((1 << (31 + l)) + d - 1) // d, l - 1)


def quo(f, n):
    """``quo``: ``__umulhi(n, mul) >> shr`` for ``n < 2^31`` (ints or int64 arrays)."""
    d, mul, shr = f
    assert np.all(np.asarray(n) < 1 << 31) and mul < U32
    q = n if d == 1 else ((np.asarray(n, dtype=np.uint64) * np.uint64(mul)) >> np.uint64(32 + shr))
    q = np.asarray(q, dtype=np.int64)
    assert np.array_equal(q, np.asarray(n) // d)  # the fast division is exact on its domain
    return q if q.ndim else int(q)


# -- K5 ---------------------------------------------------------------------------


def k5_layout(shape):
    """``launch_zero_shells``' view of a buffer: ``(planes, rows, n,
    head_planes)``; a 2D buffer is one plane of n0 rows."""
    if len(shape) == 3:
        return shape[0], shape[1], shape[2], G
    return 1, shape[0], shape[1], 0


def k5_args(shape, itemsize, phase):
    planes, rows, n, hp = k5_layout(shape)
    W = 16 // itemsize
    chunk = THREADS * ZERO_VECTORS * W
    S2 = n + 2 * G
    plane = (rows + 2 * G) * S2
    a = dict(planes=planes, rows=rows, n=n, hp=hp, W=W, chunk=chunk, S2=S2, plane=plane,
             head=hp * plane + G * S2 + G, mid=2 * G * S2 + 2 * G, phase=phase)
    a["head_blocks"] = -(-a["head"] // chunk)
    a["mid_blocks"] = -(-a["mid"] // chunk)
    a["long_blocks"] = 2 * a["head_blocks"] + (planes - 1) * a["mid_blocks"]
    a["items"] = planes * (rows - 1) * SEAM_LANES
    a["seam_blocks"] = -(-a["items"] // (THREADS * SEAMS))
    a["div_mid"], a["div_seams"] = fast_div(a["mid_blocks"]), fast_div(max(rows - 1, 1))
    return a


def k5_long_block(a, b):
    """Block ``b`` of the long gaps: ``(scalar offsets, vector offsets)``."""
    between = (a["planes"] - 1) * a["mid_blocks"]
    if b < a["head_blocks"]:
        g, c = 0, b
    elif b - a["head_blocks"] < between:
        r = b - a["head_blocks"]
        g = 1 + quo(a["div_mid"], r)
        c = r - (g - 1) * a["mid_blocks"]
    else:
        g, c = a["planes"], b - a["head_blocks"] - between
    W, chunk = a["W"], a["chunk"]
    start = c * chunk
    if g:
        start += (a["hp"] + g - 1) * a["plane"] + (a["rows"] + 2) * a["S2"] + G + a["n"]
    left = (a["head"] if g in (0, a["planes"]) else a["mid"]) - c * chunk
    cnt = min(left, chunk)
    lead = min((a["phase"] - start) % U32 & (W - 1), cnt)
    vecs = (cnt - lead) // W
    tail = lead + vecs * W
    t = np.arange(THREADS)
    scal = np.concatenate([start + t[t < lead], start + tail + t[t < cnt - tail]])
    v = (np.arange(ZERO_VECTORS)[:, None] * THREADS + t).ravel()
    return scal, start + lead + v[v < vecs] * W


def k5_seam_items(a, blocks):
    """The seam blocks ``blocks``' work items: ``(item, element offsets of its
    stores)``, as each thread decodes its items."""
    run = 2 * G // SEAM_LANES
    w = ((np.asarray(blocks)[:, None, None] * (THREADS * SEAMS)
          + np.arange(SEAMS)[:, None] * THREADS + np.arange(THREADS))).ravel()
    w = w[w < a["items"]]
    q, part = w // SEAM_LANES, w % SEAM_LANES
    pl = quo(a["div_seams"], q)
    r = q - pl * (a["rows"] - 1)
    within = (r + G) * a["S2"] + G + a["n"] + part * run  # the kernel's 32-bit offset in a plane
    assert np.all(within < U32)
    base = (a["hp"] + pl) * a["plane"] + within
    return w, base[:, None] + np.arange(run)


def k5_blocks(a):
    """The grid's blocks and each block's ``(seam blocks, long gap chunks)``:
    block b takes seam block b and chunk b, those that exist."""
    L, S = a["long_blocks"], a["seam_blocks"]
    grid = max(L, S)
    return grid, [(range(b, min(b + 1, S)), range(b, min(b + 1, L))) for b in range(grid)]


def k5_model(shape, itemsize, phase):
    """Every store of K5 on a buffer of ``shape``: ``(scalar offsets, vector
    offsets)``; each long gap's chunk and seam item checked to be taken once."""
    a = k5_args(shape, itemsize, phase)
    _, blocks = k5_blocks(a)
    seam_blocks = [u for seams, _ in blocks for u in seams]
    chunks = [u for _, longs in blocks for u in longs]
    assert sorted(chunks) == list(range(a["long_blocks"]))
    assert sorted(seam_blocks) == list(range(a["seam_blocks"]))
    parts = [k5_long_block(a, b) for b in chunks]
    w, seams = k5_seam_items(a, seam_blocks)
    assert np.array_equal(np.sort(w), np.arange(a["items"]))
    scal = np.concatenate([p[0] for p in parts] + [seams.ravel()]).astype(np.int64)
    vec = np.concatenate([p[1] for p in parts]).astype(np.int64)
    return scal, vec, a


K5_SHAPES_3D = [(1, 1, 1), (2, 3, 1), (3, 2, 9), (1, 7, 5), (4, 5, 6), (3, 3, 8), (8, 9, 10),
                (4, 30, 40), (3, 2, 700), (5, 3, 690), (2, 1, 7)]
K5_SHAPES_2D = [(1, 1), (3, 2), (2, 7), (4, 9), (67, 131), (3, 1400), (130, 3)]


def _shell(shape):
    mask = torch.ones(tv2.padded_shape(shape), dtype=torch.bool)
    tv2.unpack_padded(mask, shape).fill_(False)
    return mask.numpy().ravel()


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape", K5_SHAPES_3D + K5_SHAPES_2D,
                         ids=lambda s: "x".join(map(str, s)))
def test_k5_gap_map_matches_plain(shape, dtype):
    """On buffers 0..W-1 elements past a 16-byte boundary: every shell node
    written once, no interior node, each vector store aligned; zeroing what
    the threads write equals ``zero_pad_shells_plain`` bit for bit."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    W = 16 // itemsize
    numel = int(np.prod(tv2.padded_shape(shape)))
    shell = _shell(shape)
    rng = np.random.default_rng(sum(shape) + itemsize)
    for off in range(W):
        scal, vec, a = k5_model(shape, itemsize, (W - off) % W)
        assert np.all((vec + off) % W == 0)  # the vector's address on a 16-byte boundary
        written = np.concatenate([scal, (vec[:, None] + np.arange(W)).ravel()])
        assert written.min() >= 0 and written.max() < numel
        count = np.bincount(written, minlength=numel)
        assert np.array_equal(count, shell.astype(np.int64)), (off, np.flatnonzero(count != shell))
        buf = torch.from_numpy(rng.standard_normal(tv2.padded_shape(shape))).to(dtype)
        ref = tbwd.zero_pad_shells_plain(buf.clone(), shape)
        got = buf.clone().view(-1)
        got[torch.from_numpy(written)] = 0
        assert torch.equal(_bits(got.view(buf.shape)), _bits(ref))


@pytest.mark.parametrize("dims", [3, 2])
def test_k5_block_counts(dims):
    """At the main paths' sizes (512^3, 4096^2): the seam items and blocks and
    the long gaps' chunks fit their 32-bit counters; a chunk is a block's
    vectors."""
    shape = (512,) * 3 if dims == 3 else (4096,) * 2
    for itemsize in (4, 8):
        a = k5_args(shape, itemsize, 0)
        assert a["long_blocks"] + a["seam_blocks"] < 1 << 31 and a["items"] < 1 << 31
        assert a["chunk"] == THREADS * ZERO_VECTORS * a["W"]
        seams = 512 * 511 if dims == 3 else 4095
        assert a["items"] == seams * SEAM_LANES


# -- K2's single-axis phase ------------------------------------------------------------


ROW_SEAMS = AXIS_THREADS // (2 * G)  # axis 2: the seams a block


def axis_args(shape, ax):
    """``launch_refresh``'s ``AxisPhase`` of axis ``ax`` and its grid."""
    n0, n1, n2 = shape
    S0, S1, S2 = (n + 2 * G for n in shape)
    plane = S1 * S2
    lines = n1 * n2 if ax == 0 else S0 * n2 if ax == 1 else S0 * S1
    return dict(
        n=shape[ax], n2=n2, div_n2=fast_div(n2), lines=lines,
        first=G * S2 + G if ax == 0 else G,
        a_stride=plane if ax == 1 else S2,
        step=plane if ax == 0 else S2 if ax == 1 else 1,
        blocks=lines // ROW_SEAMS + 1 if ax == 2 else -(-lines // AXIS_THREADS))


def line_base(a, t):
    """Axes 0 and 1: padded index 0 of thread ``t``'s line (``t`` an int64
    array), decoded as the kernel does: the block's first line t0 a 64-bit
    index, the rest 32-bit."""
    t = np.asarray(t, dtype=np.int64)
    t0, tid = t - t % AXIS_THREADS, t % AXIS_THREADS
    n2 = a["n2"]
    small = t0 < 1 << 31
    i0 = np.where(small, quo(a["div_n2"], np.where(small, t0, 0)), t0 // n2)
    assert np.all(i0 < U32)
    r = t0 - i0 * n2 + tid
    assert np.all(r < 1 << 31)
    di = quo(a["div_n2"], r)
    return a["first"] + (i0 + di) * a["a_stride"] + (r - di * n2)


def row_lanes(a, block, tid):
    """Axis 2: ``(row, slot)`` of lane ``tid`` of ``block`` (int64 arrays), and
    whether it writes: lane e of seam q writes row q-1's right ghost e (slot
    e + 3) for e < 3, else row q's left ghost e - 3."""
    block, tid = np.asarray(block, dtype=np.int64), np.asarray(tid, dtype=np.int64)
    dq, e = tid // (2 * G), tid % (2 * G)
    q = block * ROW_SEAMS + dq
    row = np.where(e < G, q - 1, q)
    live = (dq < ROW_SEAMS) & (row >= 0) & (row < a["lines"])
    return row, np.where(e < G, e + G, e - G), live


def _slot(g, n):
    """``slot_pos``, ``slot_side``, ``slot_dist`` of slot ``g``."""
    return (g if g < G else n + g), int(g >= G), (G - g if g < G else g - 2)


def phase_items(a, ax):
    """``[(slot, bases)]``: the lines whose ghost ``slot`` the phase's threads
    write, by padded index 0 of the line."""
    if ax < 2:  # a thread a line, its six ghosts
        base = line_base(a, np.arange(a["lines"]))
        return [(g, base) for g in range(2 * G)]
    blocks = np.repeat(np.arange(a["blocks"]), AXIS_THREADS)
    row, slot, live = row_lanes(a, blocks, np.tile(np.arange(AXIS_THREADS), a["blocks"]))
    return [(g, row[live & (slot == g)] * a["a_stride"]) for g in range(2 * G)]


def axis_phase_model(P, bcs, shape, ax, gate=True):
    """What the threads of axis ``ax``'s phase write into ``P`` (in place):
    each ghost from its line's interior nodes, read before any write.
    Returns the written and the read element offsets."""
    if not gate:  # every block reads the flag and exits
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    a = axis_args(shape, ax)
    kinds, degrees, weights = tv2._ghost_args(bcs, shape)
    w = np.asarray(weights[:]).reshape(3, 2, G, 8)
    flat = P.view(-1)
    n, step = a["n"], a["step"]
    reads, writes, vals = [], [], []
    for g, base in phase_items(a, ax):
        base = torch.from_numpy(base)

        def node(m):
            idx = base + (G + m) * step
            reads.append(idx)
            return flat[idx]

        pos, side, k = _slot(g, n)
        kind, deg = kinds[2 * ax + side], degrees[2 * ax + side]
        if kind == 2:  # extrapolation: 0 + w0 x0 + w1 x1 + ..., nodes from the face inward
            m0, sgn = (0, 1) if side == 0 else (n - 1, -1)
            v = torch.zeros_like(node(m0))
            for j in range(deg + 1):
                v = v + torch.tensor(w[ax, side, k - 1, j], dtype=P.dtype) * node(m0 + sgn * j)
        else:  # periodic: -k <- n-1-k, n-1+k <- k; symmetry the mirror
            v = node(k if (kind == 1) == (side == 0) else n - 1 - k)
        writes.append(base + pos * step)
        vals.append(v)
    for idx, v in zip(writes, vals):
        flat[idx] = v
    return torch.cat(writes).numpy(), torch.cat(reads).numpy()


def _small_cases(shape):
    """Extrapolation cases an axis of ``min(shape)`` nodes takes."""
    E = T.Extrapolation
    out = [("extrap0", T.normalize_bcs(E(0), 3))]
    if min(shape) >= 2:
        out.append(("sides01", T.normalize_bcs([(E(1), E(0)), (E(0), E(1)), (E(1), E(1))], 3)))
    if min(shape) >= 3:
        out.append(("extrap2", T.normalize_bcs(E(2), 3)))
    return out


AXIS_SHAPES = [(4, 5, 6), (8, 9, 10), (9, 13, 70), (5, 12, 7)]
AXIS_CASES = ([(s, name, bcs) for s in AXIS_SHAPES for name, bcs, least in _cases()
               if min(s) >= least]
              + [(s, name, bcs) for s in [(1, 7, 5), (3, 2, 9), (2, 3, 1), (3, 1, 4)]
                 for name, bcs in _small_cases(s)])
AXIS_IDS = [f"{'x'.join(map(str, s))}-{n}" for s, n, _ in AXIS_CASES]


def _scribbled(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(tv2.padded_shape(shape))).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape,name,bcs", AXIS_CASES, ids=AXIS_IDS)
def test_axis_phase_map_matches_plain(shape, name, bcs, dtype):
    """Each axis's phase: the model equals ``refresh_axis_plain`` bit for bit,
    writes every ghost of that axis's shells once and nothing else, and no
    thread writes what any thread reads; gated off it writes nothing."""
    numel = int(np.prod(tv2.padded_shape(shape)))
    for ax in range(3):
        P = _scribbled(shape, dtype, 100 * ax + sum(shape))
        ref = tv2.refresh_axis_plain(P.clone(), bcs, shape, ax)
        got = P.clone()
        written, read = axis_phase_model(got, bcs, shape, ax)
        assert torch.equal(_bits(got), _bits(ref)), ax
        mask = torch.zeros(tv2.padded_shape(shape), dtype=torch.bool)
        for side in ("left", "right"):
            mask[tv2._shell_slices(ax, shape, side)] = True
        count = np.bincount(written, minlength=numel)
        assert np.array_equal(count, mask.numpy().ravel().astype(np.int64)), ax
        assert not np.isin(read, written).any()
        off = P.clone()
        assert axis_phase_model(off, bcs, shape, ax, gate=False)[0].size == 0
        assert torch.equal(_bits(off), _bits(P))


@pytest.mark.parametrize("flags", [(1, 1), (1, 0), (0, 1), (0, 0)],
                         ids=lambda f: f"flags{f[0]}{f[1]}")
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape,name", [((8, 9, 10), "mixed7"), ((9, 13, 70), "sides"),
                                        ((4, 5, 6), "periodic"), ((3, 2, 9), "extrap0")],
                         ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_three_phases_under_gates(shape, name, dtype, flags):
    """The three-launch route of K2's 3D entry and of K7 (beyond 32-bit
    indices): the phases in order, axes 0 and 1 gated by flags[0] and axis 2
    by flags[1], equal ``refresh_band_ghosts_plain`` bit for bit (and, all
    on, ``refresh_ghosts_plain``)."""
    bcs = dict((n, b) for n, b, _ in _cases()).get(name) or dict(_small_cases(shape))[name]
    P = _scribbled(shape, dtype, sum(flags) + len(name))
    got = P.clone()
    for ax in range(3):
        axis_phase_model(got, bcs, shape, ax, gate=bool(flags[ax // 2]))
    f = torch.tensor(flags, dtype=torch.int32)
    ref = bd.refresh_band_ghosts_plain(P.clone(), bcs, shape, f)
    assert torch.equal(_bits(got), _bits(ref))
    if flags == (1, 1):
        assert torch.equal(_bits(got), _bits(tv2.refresh_ghosts_plain(P.clone(), bcs, shape)))


# -- past 2^31 elements: a few thread indices decoded, nothing allocated -----------------


@pytest.mark.parametrize("shape,ax", [((20000, 18000, 1), 0), ((2, 60000, 40000), 0),
                                      ((60000, 2, 40000), 1)],
                         ids=["axis0-short", "axis0", "axis1"])
def test_axis_decode_past_2_31(shape, ax):
    """Axes 0 and 1 on a buffer past 2^31 elements: the lines of threads
    around 2^31, at block edges and the last one decode to the line's direct
    padded index."""
    S = [n + 2 * G for n in shape]
    assert np.prod(S) > 1 << 31
    a = axis_args(shape, ax)
    L = a["lines"]
    t = np.array(sorted({0, 1, 255, 256, 257, L // 2, L - 257, L - 256, L - 1}
                        | ({(1 << 31) - 1, 1 << 31, (1 << 31) + 300} if L > (1 << 31) + 300
                           else set())), dtype=np.int64)
    got = line_base(a, t)
    n2, S2, plane = shape[2], S[2], S[1] * S[2]
    i, k = t // n2, t % n2
    want = (G + i) * S2 + G + k if ax == 0 else i * plane + G + k
    assert np.array_equal(got, want)
    last = got[-1] + (2 * G + a["n"] - 1) * a["step"]
    assert last < np.prod(S)  # the last line's far ghost lies in the buffer


@pytest.mark.parametrize("shape", [(20000, 18000, 1), (1300, 1300, 1300)], ids=["n2-1", "1300"])
def test_rows_decode_past_2_31(shape):
    """Axis 2 on a buffer past 2^31 elements: every lane of the first, last
    and a middle block writes the seam's contiguous element ``q S2 - 3 + e``,
    the last one the buffer's last element."""
    numel = int(np.prod([n + 2 * G for n in shape]))
    assert numel > 1 << 31
    a = axis_args(shape, 2)
    S2 = shape[2] + 2 * G
    for block in (0, a["blocks"] // 2, a["blocks"] - 1):
        tid = np.arange(AXIS_THREADS)
        row, slot, live = row_lanes(a, np.full(AXIS_THREADS, block), tid)
        got = row * S2 + np.where(slot < G, slot, shape[2] + slot)
        q, e = block * ROW_SEAMS + tid // (2 * G), tid % (2 * G)
        assert np.array_equal(got[live], (q * S2 - G + e)[live])
        assert got[live].min() >= 0 and got[live].max() < numel
    assert got[live].max() == numel - 1


@pytest.mark.parametrize("shape", [(1300, 1300, 1300), (50000, 50000), (4, 20000, 20000)],
                         ids=["3d", "2d", "3d-few-planes"])
def test_k5_decode_past_2_31(shape):
    """K5 on a buffer past 2^31 elements: the tail's last chunk, a gap between
    planes and the last seams decode to their direct offsets, inside the
    buffer and on the shell."""
    numel = int(np.prod([n + 2 * G for n in shape]))
    assert numel > 1 << 31
    a = k5_args(shape, 4, 0)
    assert a["plane"] < U32 and a["items"] < 1 << 31
    grid, blocks = k5_blocks(a)
    assert grid < 1 << 31 and list(blocks[a["long_blocks"] - 1][1]) == [a["long_blocks"] - 1]
    scal, vec = k5_long_block(a, a["long_blocks"] - 1)  # the tail's last chunk
    end = max(scal.max(initial=-1), vec.max(initial=-1) + a["W"] - 1)
    assert end == numel - 1
    if a["planes"] > 1:  # the last gap between planes
        b = a["head_blocks"] + (a["planes"] - 1) * a["mid_blocks"] - 1
        scal, vec = k5_long_block(a, b)
        lo = min(scal.min(initial=numel), vec.min(initial=numel))
        hi = max(scal.max(initial=-1), vec.max(initial=-1) + a["W"] - 1)
        S2, plane = a["S2"], a["plane"]
        gap_end = (a["hp"] + a["planes"] - 1) * plane + G * S2 + G  # the last plane's first node
        assert hi == gap_end - 1 and lo >= gap_end - a["mid"]
    w, offs = k5_seam_items(a, [a["seam_blocks"] - 1])
    q = w // SEAM_LANES
    pl, r = q // (a["rows"] - 1), q % (a["rows"] - 1)
    want = ((a["hp"] + pl) * a["plane"] + (r + G) * a["S2"] + G + a["n"]
            + (w % SEAM_LANES) * (2 * G // SEAM_LANES))
    assert np.array_equal(offs[:, 0], want) and offs.max() < numel
    assert q.max() == a["planes"] * (a["rows"] - 1) - 1  # the last seam is taken


# -- against JAX ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 8, 7), (4, 16, 12)], ids=lambda s: "x".join(map(str, s)))
def test_zero_pad_shells_against_jax(shape):
    """JAX's ``_zero_pad_shells`` (its Pallas kernel in interpret mode, on its
    layout: 8 rows of pad on axis 1, none on axis 2) and the port's
    ``zero_pad_shells`` on the same interior in float64: the interiors are
    equal to it and both shells are zero."""
    n0, n1, n2 = shape
    assert n1 % 8 == 0 and jbwd._HAS_PALLAS  # JAX's Pallas kernel runs (not its jnp.pad)
    rng = np.random.default_rng(7)
    inner = rng.standard_normal(shape)
    jbuf = rng.standard_normal((n0 + 2 * G, n1 + 16, n2))
    jbuf[G:G + n0, 8:8 + n1, :] = inner
    got_j = np.asarray(jbwd._zero_pad_shells(jnp.asarray(jbuf), shape, interpret=True))
    tbuf = torch.from_numpy(rng.standard_normal(tv2.padded_shape(shape)))
    tv2.unpack_padded(tbuf, shape).copy_(torch.from_numpy(inner))
    got_t = tbwd.zero_pad_shells(tbuf, shape)
    assert np.array_equal(got_j[G:G + n0, 8:8 + n1, :], inner)
    assert np.array_equal(tv2.unpack_padded(got_t, shape).numpy(), inner)
    jshell = np.ones(got_j.shape, dtype=bool)
    jshell[G:G + n0, 8:8 + n1, :] = False
    assert not got_j[jshell].any()
    assert not got_t.numpy().ravel()[_shell(shape)].any()
