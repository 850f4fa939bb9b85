"""The ghost kernels' route for an ``Extrapolation`` of degree above 7, on the
CPU in float64: the plain ghost refresh (K2, its single axis), the gated
band refresh (K7) under its four gates and the fold (K4) at degrees 8 and
11, 3D and 2D, mixed with Periodic and Symmetry, against JAX's
``pad_ghost`` and its VJP; the device table's weights against JAX's
Lagrange weights, in the buffer's dtype; a model of the table route's line
threads (chunks of ``kTableChunk`` nodes) against the plain phase; the
wrappers' dispatch of a CUDA-typed buffer to the table route (the by-value
kernels' threads reading a table of weights, one launch a wrapper, counted
in ``table_launches``); and the sharded refresh's edge slabs, deep enough
for the degree. Every input comes from a numpy seed.
"""

import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsm_tpu.core import bc as jbc
from lsm_tpu_torch.core import bc as tbc
from lsm_tpu_torch.core.grid import Grid
from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import weno_v2 as tv2
from lsm_tpu_torch.ops import weno_v2_bwd as tbwd
from lsm_tpu_torch.parallel import fused_evolve as sfe
from lsm_tpu_torch.parallel import make_mesh
from test_torch_dense_2d import _CudaTyped

G = tv2.GHOST

CASES = {
    "e8": ((13, 14, 15), [("E", 8)] * 3),
    "e11": ((12, 13, 16), [("E", 11)] * 3),
    "mixed": ((13, 12, 14), [(("E", 8), ("E", 11)), ("P",), (("E", 9), ("S",))]),
    "2d_e11": ((12, 17), [("E", 11), ("P",)]),
    "2d_mixed": ((20, 12), [(("S",), ("E", 9)), (("E", 11), ("E", 0))]),
}


def _bcs(m, spec):
    make = lambda s: {"E": lambda: m.Extrapolation(s[1]), "P": m.Periodic,
                      "S": m.Symmetry}[s[0]]()
    out = []
    for pair in spec:
        pair = pair if isinstance(pair[0], tuple) else (pair, pair)
        out.append(tuple(make(s) for s in pair))
    return tuple(out)


def _inputs(name, seed=0):
    shape, spec = CASES[name]
    rng = np.random.default_rng(seed)
    P = rng.standard_normal(tuple(n + 2 * G for n in shape))
    return shape, _bcs(tbc, spec), _bcs(jbc, spec), P


def _interior(a, shape):
    return a[tuple(slice(G, G + n) for n in shape)]


def _tol(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_refresh_matches_jax_pad_ghost(name):
    shape, tb, jb, P = _inputs(name)
    got = tv2.refresh_ghosts_plain(torch.from_numpy(P.copy()), tb, shape).numpy()
    ref = np.asarray(jbc.pad_ghost(jnp.asarray(_interior(P, shape)), jb, G))
    assert np.abs(got - ref).max() <= _tol(ref)
    if len(shape) == 3:  # the single-axis phases in order compose the refresh
        buf = torch.from_numpy(P.copy())
        for ax in range(3):
            tv2.refresh_axis_plain(buf, tb, shape, ax)
        assert torch.equal(buf, torch.from_numpy(got))


@pytest.mark.parametrize("name", list(CASES))
def test_fold_matches_the_vjp_of_jax_pad_ghost(name):
    shape, tb, jb, g = _inputs(name, seed=1)
    got = tbwd.fold_ghost_cotangent_plain(torch.from_numpy(g.copy()), tb, shape).numpy()
    _, vjp = jax.vjp(lambda v: jbc.pad_ghost(v, jb, G), jnp.zeros(shape))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    assert np.abs(_interior(got, shape) - ref).max() <= _tol(ref)
    shells = got.copy()
    shells[tuple(slice(G, G + n) for n in shape)] = 0.0
    assert not shells.any()


def _jax_gated(P, jb, shape, flags):
    """JAX's gated refresh from its ghost blocks: the phases in order, each
    where its flag is set, over the lines it covers (earlier axes whole,
    later ones' interior)."""
    out = jnp.asarray(P)
    gates = flags if len(shape) == 2 else (flags[0], flags[0], flags[1])
    for ax, gate in enumerate(gates):
        if not gate:
            continue
        src = tuple(slice(None) if d < ax else slice(G, G + n) for d, n in enumerate(shape))
        line = out[src]
        left = jbc._ghost_block(line, jb[ax][0], ax, G, "left")
        right = jbc._ghost_block(line, jb[ax][1], ax, G, "right")
        for side, block in (("left", left), ("right", right)):
            dst = tuple(
                s if d != ax else (slice(0, G) if side == "left" else slice(G + shape[ax], None))
                for d, s in enumerate(src))
            out = out.at[dst].set(block)
    return np.asarray(out)


@pytest.mark.parametrize("flags", list(itertools.product((0, 1), repeat=2)))
@pytest.mark.parametrize("name", ["e11", "mixed", "2d_e11", "2d_mixed"])
def test_gated_band_refresh_matches_jax(name, flags):
    shape, tb, jb, P = _inputs(name, seed=2)
    got = bd.refresh_band_ghosts_plain(torch.from_numpy(P.copy()), tb, shape,
                                       torch.tensor(flags, dtype=torch.int32)).numpy()
    ref = _jax_gated(P, jb, shape, flags)
    assert np.abs(got - ref).max() <= _tol(ref)
    if flags == (1, 1):
        full = np.asarray(jbc.pad_ghost(jnp.asarray(_interior(P, shape)), jb, G))
        assert np.abs(got - full).max() <= _tol(full)


@pytest.mark.parametrize("name", ["mixed", "2d_mixed"])
def test_table_holds_jax_weights(name):
    shape, tb, _, _ = _inputs(name)
    w, dmax = tv2._ghost_table(tb, shape, "cpu")
    assert dmax == 11 and w.dtype == torch.float64
    table = w.numpy().reshape(2 * len(shape), G, dmax + 1)
    for ax in range(len(shape)):
        for side in range(2):
            b = tb[ax][side]
            if not isinstance(b, tbc.Extrapolation):
                assert not table[2 * ax + side].any()
                continue
            W = np.asarray(jbc._lagrange_extrap_weights(G, b.degree))  # rows outermost first
            for k in range(1, G + 1):
                np.testing.assert_array_equal(table[2 * ax + side, k - 1, :b.degree + 1],
                                              W[G - k])
                assert not table[2 * ax + side, k - 1, b.degree + 1:].any()
    kinds, degrees, weights = tv2._ghost_args(tb, shape)
    assert max(degrees) == 11 and tv2._ghost_table(tb, shape, "cpu") is tv2._ghost_table(
        tb, shape, "cpu")
    assert tv2._ghost_table(tbc.normalize_bcs(tbc.Extrapolation(7), len(shape)), shape,
                            "cpu") is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_table_in_the_buffers_dtype(dtype):
    """The table the kernels read is the float64 table rounded once to the
    buffer's dtype (the by-value route rounds each weight the same way), one
    tensor per BCs, shape, device and dtype."""
    shape, tb, _, _ = _inputs("mixed")
    w64, dmax = tv2._ghost_table(tb, shape, "cpu")
    w, d = tv2._ghost_table(tb, shape, "cpu", dtype)
    assert d == dmax and w.dtype == dtype and torch.equal(w, w64.to(dtype))
    assert tv2._ghost_table(tb, shape, "cpu", dtype)[0] is w


def _table_chunk():
    """``kTableChunk``: the nodes an extrapolating line loads at once."""
    src = (Path(tv2.__file__).parent.parent / "csrc" / "refresh_ghosts.cu").read_text()
    return int(re.search(r"constexpr int kTableChunk = (\d+);", src).group(1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", [8, 16, 19])
def test_chunked_sums_equal_the_plain_ghosts(degree, dtype):
    """A model of the table route's line threads (``table_ghosts``): the
    axis-2 ghosts of every row from the table's weights, the P + 1 nodes in
    chunks of ``kTableChunk``, each ghost's sum from 0 in the nodes' order,
    equal bit for bit to the plain phase on both sides."""
    shape = (3, 4, degree + 5)
    bcs = tbc.normalize_bcs([tbc.Periodic(), tbc.Symmetry(),
                             (tbc.Extrapolation(degree), tbc.Extrapolation(degree - 1))], 3)
    P = torch.from_numpy(np.random.default_rng(degree).standard_normal(
        tv2.padded_shape(shape))).to(dtype)
    want = tv2.refresh_axis_plain(P.clone(), bcs, shape, 2)
    w, dmax = tv2._ghost_table(bcs, shape, "cpu", dtype)
    chunk, n = _table_chunk(), shape[2]
    got = P.clone()
    for side in range(2):
        deg = bcs[2][side].degree
        nodes = [P[..., G + (j if side == 0 else n - 1 - j)] for j in range(deg + 1)]
        for k in range(1, G + 1):
            row = w[((2 * 2 + side) * G + k - 1) * (dmax + 1):][:deg + 1]
            val = torch.zeros_like(nodes[0])
            for c in range(0, deg + 1, chunk):
                for j in range(c, min(c + chunk, deg + 1)):
                    val = val + row[j] * nodes[j]
            got[..., G - k if side == 0 else G + n - 1 + k] = val
    assert torch.equal(got, want)


def test_wrappers_take_the_table_route_on_cuda(monkeypatch):
    """A CUDA-typed buffer with a degree above 7 goes to the table route (here
    its launch replaced by the plain version of the op it names): K2 all
    phases, K2's single axis one phase, K7 with its flags, K4 the fold into a
    new buffer; each wrapper counts one launch and one table launch."""
    calls = []

    def launch(op, g, padded, bcs, shape, table, axis_lo=0, axis_hi=None, flags=None):
        calls.append((op, axis_lo, axis_hi, None if flags is None else flags.tolist()))
        plain = lambda x: None if x is None else x.as_subclass(torch.Tensor)
        g, padded, flags = plain(g), plain(padded), plain(flags)
        if op == tv2.TABLE_FOLD:
            padded.copy_(tbwd.fold_ghost_cotangent_plain(g.clone(), bcs, shape))
        elif flags is not None:
            bd.refresh_band_ghosts_plain(padded, bcs, shape, flags)
        else:
            for ax in range(axis_lo, len(shape) if axis_hi is None else axis_hi):
                tv2.refresh_axis_plain(padded, bcs, shape, ax)

    monkeypatch.setattr(tv2, "ghost_table_launch", launch)
    monkeypatch.setattr(tv2, "_ghost_table", lambda bcs, shape, device, dtype: ("table", 11))
    shape, tb, _, P = _inputs("mixed", seed=3)
    fns = (tv2.refresh_ghosts_fast, tv2.refresh_axis_fast, bd.refresh_band_ghosts_fast,
           tbwd.fold_ghost_cotangent_fast)
    for fn in fns:
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "table_launches", 0)
    cuda = lambda a: torch.from_numpy(a.copy()).as_subclass(_CudaTyped)
    flags = torch.tensor([0, 1], dtype=torch.int32)
    monkeypatch.setattr(_CudaTyped, "device", property(lambda self: torch.device("cuda")),
                        raising=False)
    outs = [tv2.refresh_ghosts_fast(cuda(P), tb, shape),
            tv2.refresh_axis_fast(cuda(P), tb, shape, 1)]
    flags_c = flags.as_subclass(_CudaTyped)
    outs.append(bd.refresh_band_ghosts_fast(cuda(P), tb, shape, flags_c))
    outs.append(tbwd.fold_ghost_cotangent_fast(cuda(P), tb, shape))
    assert calls == [(0, 0, None, None), (0, 1, 2, None), (0, 0, None, [0, 1]),
                     (1, 0, None, None)]
    assert all(fn.launches == fn.table_launches == 1 for fn in fns)
    t = torch.from_numpy(P.copy())
    want = [tv2.refresh_ghosts_plain(t.clone(), tb, shape),
            tv2.refresh_axis_plain(t.clone(), tb, shape, 1),
            bd.refresh_band_ghosts_plain(t.clone(), tb, shape, flags),
            tbwd.fold_ghost_cotangent_plain(t.clone(), tb, shape)]
    for got, ref in zip(outs, want):
        assert torch.equal(got.as_subclass(torch.Tensor), ref)


def test_sharded_refresh_reads_edges_deep_enough():
    """A mesh of 2 x 2 shards of a grid under Extrapolation(11) on the split
    axes: the BC blocks read 12-node edge slabs, and the sharded refresh
    equals the whole buffer's plain refresh shard by shard."""
    shape = (24, 26, 12)
    bcs = tbc.normalize_bcs(tbc.Extrapolation(11), 3)
    mesh = make_mesh(devices=["cpu"] * 4, mesh_shape=(2, 2), axis_names="xy")
    layout = sfe.ShardLayout(mesh, Grid((0.0,) * 3, (1.0,) * 3, shape))
    vals = torch.from_numpy(np.random.default_rng(4).standard_normal(shape))
    whole = tv2.pack_padded(vals, bcs)
    n0, n1, n2 = layout.local_shape
    bufs = []
    for (i, j) in layout.pos:
        local = vals[i * n0:(i + 1) * n0, j * n1:(j + 1) * n1]
        bufs.append(torch.zeros(tv2.padded_shape(layout.local_shape), dtype=torch.float64))
        bufs[-1][G:G + n0, G:G + n1, G:G + n2] = local
    sfe.refresh_ghosts_sharded(bufs, bcs, layout)
    for (i, j), buf in zip(layout.pos, bufs):
        want = whole[i * n0:i * n0 + n0 + 2 * G, j * n1:j * n1 + n1 + 2 * G]
        tol = 1e-12 * float(want.abs().max())
        # ghosts on a face between shards are the neighbour's nodes; on a
        # physical face the degree-11 extrapolation of the shard's own edge
        torch.testing.assert_close(buf, want, rtol=0, atol=tol)
