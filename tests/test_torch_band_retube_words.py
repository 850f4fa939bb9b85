"""The bit-plane algorithm of K8 (``lsm_tpu_torch/csrc/band_retube.cu``) as a
word-level model in plain torch, held against the plain re-tube
``band_retube_plain`` (which ``test_torch_band.py`` holds against JAX's
kernel in interpret mode and the full re-tube).

The model follows the kernel's three launches step by step. The tag launch
writes each active candidate node's signs into its mask byte's bits 4
(phi <= 0) and 5 (phi >= 0). The re-tube takes per candidate tile a region of rows
along the last axis, each row 32-bit words (kept in int64 tensors and
masked to 32 bits) of one bit a node for phi <= 0, phi >= 0 and the old
active mask, read from the mask bytes (an active node left untagged, in a
tile that is no candidate or NaN, from phi); cut cells as ORs/ANDs of
neighbouring rows and a shift by one carried across word boundaries; the
stamp; the two box dilations as shifts along the row and ORs of rows; the
tile's new value into its bytes' bits 2-3 (every read taking the low two
bits as the old value). The last launch shifts every candidate tile's bytes
down (``(v >> 2) & 3``). The cases cover rows of one, two and three words,
3D and 2D bands, ``nlayers`` 1 to 4, ragged last tiles, every face, a NaN,
active nodes outside the candidates, an empty slot and slots past
``count``.
"""

import itertools

import numpy as np
import pytest
import torch

from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import weno_v2 as v2

MASK32 = (1 << 32) - 1
CHALO = 3


def _next_word(x):
    """Each row's word w + 1 (0 past the last)."""
    return torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)


def _prev_word(x):
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _shift_down(x, d):
    """Bit b takes bit b + d of the row (a right shift carried from the next
    word)."""
    return ((x >> d) | (_next_word(x) << (32 - d))) & MASK32


def _shift_up(x, d):
    """Bit b takes bit b - d of the row (a left shift carried from the
    previous word)."""
    return ((x << d) | (_prev_word(x) >> (32 - d))) & MASK32


def _pack(bits):
    """``(..., 32 W)`` bool -> ``(..., W)`` words, bit l of word w the node
    32 w + l."""
    b = bits.reshape(*bits.shape[:-1], -1, 32).long()
    return (b << torch.arange(32)).sum(-1)


def _rows_or(x, lo, hi, n, axis):
    """OR of the rows ``r + d`` (``lo <= d <= hi``) along ``axis``, rows
    outside ``[0, n)`` empty."""
    out = torch.zeros_like(x)
    for d in range(lo, hi + 1):
        src = torch.roll(x, -d, dims=axis)
        idx = torch.arange(x.shape[axis]) + d
        keep = ((idx >= 0) & (idx < n)).reshape([-1 if a == axis else 1 for a in range(x.ndim)])
        out = out | torch.where(keep, src, torch.zeros_like(src))
    return out


def _tile_words(phi, band, origin, shape3, tiles3, na, nc, two_d):
    """The kernel's launch A for one tile: ``(active, compute)`` words of the
    tile's rows, ``(B0, B1, W)``, and the bit of tile node t2 (``t2 + H``).
    ``phi`` and ``band`` are the 3D views (a 2D band: ``(1, n0, n1)``)."""
    n0, n1, n2 = shape3
    B0, B1, B2 = tiles3
    H = nc + 1
    H0 = 0 if two_d else H
    R0, R1, N2 = B0 + 2 * H0, B1 + 2 * H, B2 + 2 * H
    W = -(-N2 // 32)
    i0, j0, k0 = origin
    i = torch.arange(R0) + i0 - H0
    j = torch.arange(R1) + j0 - H
    b = torch.arange(32 * W)
    k = b + k0 - H
    on = ((i >= 0) & (i < n0))[:, None, None] & ((j >= 0) & (j < n1))[None, :, None] \
        & ((k >= 0) & (k < n2) & (b < N2))[None, None, :]
    ic, jc, kc = i.clamp(0, n0 - 1), j.clamp(0, n1 - 1), k.clamp(0, n2 - 1)
    v = phi[ic][:, jc][:, :, kc]
    m = band[ic][:, jc][:, :, kc]
    ac = (m & 3) == 2  # the old mask: the low bits
    tagged = (m & 48) != 0
    np_ = torch.where(tagged, (m & 16) != 0, v <= 0)  # untagged: phi itself
    nn_ = torch.where(tagged, (m & 32) != 0, v >= 0)
    NP, NN, AC = (_pack(on & ac & c) for c in (np_, nn_, torch.ones_like(ac)))
    # cut cells at their lower corner's row
    crows0 = 1 if two_d else R0 - 1
    cell_rows = torch.zeros(R0, R1, 1, dtype=torch.bool)
    cell_rows[:crows0, :R1 - 1] = True

    def corners(x, op):
        y = op(x, torch.roll(x, -1, dims=1))
        if not two_d:
            y = op(y, torch.roll(y, -1, dims=0))
        return y

    anp, ann = corners(NP, torch.bitwise_or), corners(NN, torch.bitwise_or)
    aac = corners(AC, torch.bitwise_and)
    cut = (anp | _shift_down(anp, 1)) & (ann | _shift_down(ann, 1)) & (aac & _shift_down(aac, 1))
    cut = torch.where(cell_rows, cut, torch.zeros_like(cut))
    # the stamp: cells s - 1 and s along each axis
    x = _rows_or(cut, -1, 0, R1 - 1, 1)
    if not two_d:
        x = _rows_or(x, -1, 0, R0 - 1, 0)
    stamp = x | _shift_up(x, 1)
    # the dilations: along the row, then axis 1, then axis 0
    da, dc = stamp.clone(), stamp.clone()
    for d in range(1, nc + 1):
        s = _shift_up(stamp, d) | _shift_down(stamp, d)
        dc = dc | s
        if d <= na:
            da = da | s
    da = _rows_or(da, -na, na, R1, 1)[:, H:H + B1]
    dc = _rows_or(dc, -nc, nc, R1, 1)[:, H:H + B1]
    if not two_d:
        da = _rows_or(da, -na, na, R0, 0)[H0:H0 + B0]
        dc = _rows_or(dc, -nc, nc, R0, 0)[H0:H0 + B0]
    return da, dc, H


def retube_words(P, band, cand, count, nlayers, chalo, shape, tiles):
    """The kernel's two launches on the CPU: ``band`` updated in place on the
    first ``count`` slots of ``cand``; returns the flags (0 past count)."""
    two_d = len(shape) == 2
    shape3 = (1, *shape) if two_d else tuple(shape)
    tiles3 = (1, *tiles) if two_d else tuple(tiles)
    phi = v2.unpack_padded(P, shape).reshape(shape3)
    b3 = band.view(shape3)
    G = bd.tile_grid(shape3, tiles3)
    na, nc = nlayers, nlayers + chalo
    flags = torch.zeros(cand.shape[0], dtype=torch.int32)
    used = [int(t) for t in cand[:count]]

    def tile_slices(tid):
        t0, rest = divmod(tid, G[1] * G[2])
        t1, t2 = divmod(rest, G[2])
        return tuple(slice(o * t, min((o + 1) * t, n))
                     for o, t, n in zip((t0, t1, t2), tiles3, shape3))

    for tid in used:  # launch T: the active candidates' signs into bits 4 and 5
        if tid >= 0:
            sl = tile_slices(tid)
            p, act = phi[sl], ((b3[sl] & 3) == 2).to(torch.uint8)
            b3[sl] |= act * (((p <= 0).to(torch.uint8) << 4) | ((p >= 0).to(torch.uint8) << 5))
    for slot, tid in enumerate(used):  # launch A, in any order
        if tid < 0:
            continue
        t0, rest = divmod(tid, G[1] * G[2])
        t1, t2 = divmod(rest, G[2])
        origin = (t0 * tiles3[0], t1 * tiles3[1], t2 * tiles3[2])
        da, dc, H = _tile_words(phi, b3, origin, shape3, tiles3, na, nc, two_d)
        B2 = tiles3[2]
        bit = torch.arange(B2) + H
        a = (da[..., bit // 32] >> (bit % 32)) & 1
        c = (dc[..., bit // 32] >> (bit % 32)) & 1
        new = (a + c).to(torch.uint8)
        sl = tuple(slice(o, min(o + t, n)) for o, t, n in zip(origin, tiles3, shape3))
        new = new[tuple(slice(0, s.stop - s.start) for s in sl)]
        view = b3[sl]
        view.copy_(torch.where(new != 0, view | (new << 2), view))
        flags[slot] = int(bool((new != 0).any()))
    for tid in used:  # launch B: the new value; tags cleared
        if tid >= 0:
            sl = tile_slices(tid)
            b3[sl] = (b3[sl] >> 2) & 3
    return flags


def _field(shape, seed, dtype):
    """A sphere about a corner of the grid (its band crosses every face of
    the box it leaves) with noise and exact zeros (ties of both sign bits),
    and an old combined mask active within a few nodes of it with holes, so
    that the cut cells, the stamp and the dilations have edges inside the
    tiles."""
    rng = np.random.default_rng(seed)
    idx = np.meshgrid(*(np.arange(n, dtype=float) for n in shape), indexing="ij")
    centre = [0.3 * n for n in shape]
    dist = np.sqrt(sum((x - c) ** 2 for x, c in zip(idx, centre))) - 0.45 * min(shape)
    vals = dist + 0.3 * rng.standard_normal(shape)
    vals[rng.random(shape) < 0.03] = 0.0
    old = np.where(np.abs(dist) < 6, 2, np.where(np.abs(dist) < 9, 1, 0)).astype(np.uint8)
    old[rng.random(shape) < 0.05] = 0
    return torch.tensor(vals, dtype=dtype), torch.tensor(old)


# (shape, tiles): ragged last tiles on every axis; rows of one word (16^3
# tiles: 16 + 2 (nlayers + 4) <= 32), two (B2 = 32) and three (B2 = 64)
CASES = [((20, 37, 45), (16, 16, 16)), ((19, 21, 70), (8, 16, 32)),
         ((17, 19, 75), (8, 8, 64)), ((37, 133), (16, 64))]


@pytest.mark.parametrize("case,nlayers", list(itertools.product(range(len(CASES)), (1, 2, 3, 4))))
def test_bit_plane_retube_matches_plain(case, nlayers):
    shape, tiles = CASES[case]
    dtype = torch.float64 if nlayers % 2 else torch.float32
    vals, old = _field(shape, 100 * case + nlayers, dtype)
    vals.view(-1)[vals.numel() // 3] = float("nan")  # neither sign, tagged or not
    P = v2.pack_padded(vals, _bcs(len(shape)))
    total = int(np.prod(bd.tile_grid(shape, tiles)))
    rng = np.random.default_rng(7 + case)
    ids = list(rng.permutation(total)[: total - 2])  # two tiles not candidates
    ids.insert(len(ids) // 2, -1)  # an empty slot among the candidates
    count = len(ids)
    tail = [int(t) for t in rng.permutation(total)[:3]]  # past count: not re-tubed
    cand = torch.tensor(ids + tail, dtype=torch.int32)
    cnt = torch.tensor(count, dtype=torch.int32)
    b_model, b_plain = old.clone(), old.clone()
    f_model = retube_words(P, b_model, cand, count, nlayers, CHALO, shape, tiles)
    f_plain = bd.band_retube_plain(P, b_plain, cand, nlayers, CHALO, shape, tiles, cnt)
    assert torch.equal(b_model, b_plain)
    assert torch.equal(f_model, f_plain)
    # the re-tube changed nodes, and none on the tiles it did not visit
    assert int((b_plain != old).sum()) > 0
    skipped = bd.dispatched_cells(cand[:count].clone(), shape, tiles)
    assert torch.equal(b_plain[~skipped], old[~skipped])


def _bcs(ndim):
    from lsm_tpu_torch.core.bc import Extrapolation, normalize_bcs
    return normalize_bcs(Extrapolation(2), ndim)


def test_retube_count_limits_the_slots():
    """The wrapper's ``count``: slots past it are neither re-tubed nor
    flagged, on the CPU as on the card."""
    shape, tiles = (20, 37, 45), (16, 16, 16)
    vals, old = _field(shape, 5, torch.float64)
    P = v2.pack_padded(vals, _bcs(3))
    cand = torch.arange(18, dtype=torch.int32)
    full, part = old.clone(), old.clone()
    f_full = bd.band_retube_incremental(P, full, cand, 3, CHALO, shape, tiles,
                                        torch.tensor(18, dtype=torch.int32))
    f_part = bd.band_retube_incremental(P, part, cand, 3, CHALO, shape, tiles,
                                        torch.tensor(10, dtype=torch.int32))
    assert torch.equal(f_part[:10], f_full[:10]) and int(f_part[10:].abs().sum()) == 0
    first = bd.dispatched_cells(cand[:10].clone(), shape, tiles)
    assert torch.equal(part[first], full[first]) and torch.equal(part[~first], old[~first])


@pytest.mark.parametrize("bad,match", [
    (torch.tensor(3, dtype=torch.int64), "0-d int32"),
    (torch.tensor([3], dtype=torch.int32), "0-d int32"),
    (torch.tensor(3, dtype=torch.int32, device="meta"), "lies on"),
])
def test_retube_count_checks(bad, match):
    shape, tiles = (20, 37, 45), (16, 16, 16)
    vals, old = _field(shape, 6, torch.float64)
    P = v2.pack_padded(vals, _bcs(3))
    cand = torch.arange(18, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        bd.band_retube_incremental(P, old, cand, 3, CHALO, shape, tiles, bad)
