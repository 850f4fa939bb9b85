"""What binds the ghost-shell kernels: K2's 3D entry and K4 timed at 512^3 f32
with parts of `lsm_tpu_torch/csrc/refresh_ghosts.cu` or `fold_ghosts.cu`
taken out or changed; K7's one launch with other grids; K5 (512^3 and
4096^2) with other seam layouts and chunks, or its long gaps or seams alone;
K2's single-axis phases (axis 2 at the (2, 2) mesh's shard, axes 1 and 2 at
the (4, 1) mesh's, buffers in turn out of L2) with axis 2's rows laid
otherwise; K2's and K7's table route (the flagship's field under
``Extrapolation(8)``) with other register budgets.

Each variant is one source with a text substitution, built by nvcc (the
port's flags) into a library of its own under `lsm_tpu_torch/_build/`; the
wrappers of `ops/weno_v2.py`, `ops/weno_v2_bwd.py` and `ops/band.py` launch
it on the flagship's Periodic state, on config A's `Extrapolation(2)` and on
the flagship's field under mixed BCs with `Extrapolation(7)` (K2 on the
packed state, K4 on a random cotangent), K7 on the 512^3 band cells'
buffer and K7's 2D entry on D2b's, flags on and off, K5 on random buffers
and K2's single-axis phases on zeroed ones (Periodic). A variant that removes work
computes something else: only its time is read. Variants run in turns (all,
then all in reverse); each line gives the faster of a variant's two readings
of the profiler's device time and of the CUDA-event median.

From the repository root, on a machine with one H100:
    python3 tools/shell_variants.py [NAME ...]
(names: only those variants, beside "as built").
"""

from __future__ import annotations

import ctypes
import itertools
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import lsm_tpu_torch as lsm  # noqa: E402
from lsm_tpu_torch.ops import _build  # noqa: E402
from lsm_tpu_torch.ops import band as bd  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402
from lsm_tpu_torch.ops import weno_v2_bwd as bwd  # noqa: E402

_LINES_A = "  s.cnt_a = static_cast<uint32_t>(cnt_a);\n"
_LINES_B = "  s.cnt_b = static_cast<uint32_t>(cnt_b);\n"
_LINES_C = "  s.cnt_c = static_cast<uint32_t>(cnt_c);\n"
_K2_ROWS = "constexpr int kRowsC = 1;"
_EDGES_1 = "  s.cnt_e1 = static_cast<uint32_t>(cnt_e1);\n"
_EDGES_2 = "  s.cnt_e2 = static_cast<uint32_t>(cnt_e2);\n"
_EDGES_3 = "  s.cnt_e3 = static_cast<uint32_t>(cnt_e3);\n"
_K2_BOUNDS = "__global__ void __launch_bounds__(kThreads, 6) refresh_3d_kernel("
_K4_BOUNDS = "__global__ void __launch_bounds__(kThreads)\n    fold_kernel("
_K4_NODES = "  uint32_t t = (blockIdx.x - before) * kThreads + threadIdx.x;\n"
_K4_FLAT = "  if (upto > before) {\n"
_K4_VECTORS = "constexpr int kVectors = 8;"
_K4_FIRST = "  if (blockIdx.x < a.flat_blocks) {\n    const uint32_t before = blockIdx.x;\n"
_K7_BLOCKS = "constexpr int kBandBlocksPerSM = 4;"
_K7_CAP = "  blocks = static_cast<unsigned>(need < most ? need : most);\n"
_K7_BOUNDS = "__global__ void __launch_bounds__(kThreads, 4)\n    band_refresh_3d_kernel("
_K2T_BOUNDS = "__global__ void __launch_bounds__(kThreads, 4)\n    refresh_3d_table_kernel("
_K7T_BOUNDS = "__global__ void __launch_bounds__(kThreads, 4)\n    band_refresh_3d_table_kernel("
_CHUNK = "constexpr int kTableChunk = 8;"
_K5_LANES = "constexpr int kSeamLanes = 6;"
_K5_SEAMS = "constexpr int kSeams = 1;"
_K5_VECTORS = "constexpr int kZeroVectors = 1;"
_K5_GRID = "  const int64_t blocks = long_blocks > seam_blocks ? long_blocks : seam_blocks;\n"
_K5_SEAMS_CALL = "  if (blockIdx.x < a.seam_blocks) zero_seams(buf, a, blockIdx.x);\n"
_K5_CHUNK_CALL = "  if (blockIdx.x < a.long_blocks) zero_chunk(buf, a, blockIdx.x);\n"
_K5_BLOCK = _K5_SEAMS_CALL + _K5_CHUNK_CALL
_AX_SEAMS = """    const uint32_t dq = threadIdx.x / (2 * LSM_GHOST), e = threadIdx.x - dq * (2 * LSM_GHOST);
    const int64_t q = static_cast<int64_t>(blockIdx.x) * kRowSeams + dq;
    const int64_t row = e < LSM_GHOST ? q - 1 : q;
    if (dq >= kRowSeams || row < 0 || row >= a.lines) return;
    const int g = e < LSM_GHOST ? static_cast<int>(e) + LSM_GHOST : static_cast<int>(e) - LSM_GHOST;
    T* line = P + row * a.a_stride;
    const T* node = line + LSM_GHOST;
    T val[2 * LSM_GHOST];
    line_ghosts<T, kExtrap>(bc, a.n, g, g + 1, [&](int m) { return node[m]; }, val);
    T v = T(0);
#pragma unroll
    for (int h = 0; h < 2 * LSM_GHOST; ++h)
      if (h == g) v = val[h];
    line[slot_pos(g, a.n)] = v;
"""
# axis 2 a thread a padded row: its six ghosts, both ends' loads before the
# stores (each warp instruction then touches a line a lane)
_AX_ROW_THREADS = """    const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (row >= a.lines) return;
    refresh_line<T, kExtrap>(P + row * a.a_stride, 1, bc, a.n);
"""
_AX_BLOCKS = "    const int64_t blocks = axis == 2 ? a.lines / kRowSeams + 1  // the rows' lines + 1 seams\n"

#: name: (what it shows, source, substitutions, kernels it touches)
VARIANTS = {
    "as built": ("the kernels", None, [], ("K2", "K4", "K7", "K7 2D", "K5", "K5 2D", "K2ax",
                                           "K2 table", "K4 table", "K7 table")),
    "K2 table at most 40 registers": ("six blocks an SM, K2's budget", "refresh_ghosts.cu",
                                      [(_K2T_BOUNDS, _K2T_BOUNDS.replace("(kThreads, 4)",
                                                                         "(kThreads, 6)"))],
                                      ("K2 table",)),
    "K2 table at most 128 registers": ("two blocks an SM", "refresh_ghosts.cu",
                                       [(_K2T_BOUNDS, _K2T_BOUNDS.replace("(kThreads, 4)",
                                                                          "(kThreads, 2)"))],
                                       ("K2 table",)),
    "K2 table chunks of 16": (
        "an extrapolation's nodes loaded 16 at once", "refresh_ghosts.cu",
        [(_CHUNK, _CHUNK.replace("8;", "16;"))], ("K2 table", "K7 table")),
    "K2 table chunks of 16, at most 128 registers": (
        "an extrapolation's nodes loaded 16 at once, two blocks an SM", "refresh_ghosts.cu",
        [(_CHUNK, _CHUNK.replace("8;", "16;")),
         (_K2T_BOUNDS, _K2T_BOUNDS.replace("(kThreads, 4)", "(kThreads, 2)")),
         (_K7T_BOUNDS, _K7T_BOUNDS.replace("(kThreads, 4)", "(kThreads, 2)"))],
        ("K2 table", "K7 table")),
    "K7 table at most 128 registers": ("two blocks an SM, the grid of four", "refresh_ghosts.cu",
                                       [(_K7T_BOUNDS, _K7T_BOUNDS.replace("(kThreads, 4)",
                                                                          "(kThreads, 2)"))],
                                       ("K7 table",)),
    "K2 axis-2 lines only": ("the interior rows' ends", "refresh_ghosts.cu",
                             [(_LINES_A, "  s.cnt_a = 0;\n"), (_LINES_B, "  s.cnt_b = 0;\n")],
                             ("K2",)),
    "K2 axis-0 and axis-1 lines only": ("the ghost planes and rows", "refresh_ghosts.cu",
                                        [(_LINES_C, "  s.cnt_c = 0;\n")], ("K2",)),
    "K2 without the edge ghosts": ("lines only", "refresh_ghosts.cu",
                                   [(_EDGES_1, "  s.cnt_e1 = 0;\n"), (_EDGES_2, "  s.cnt_e2 = 0;\n"),
                                    (_EDGES_3, "  s.cnt_e3 = 0;\n")], ("K2",)),
    "K2 edge ghosts only": ("the ghosts of two or three axes", "refresh_ghosts.cu",
                            [(_LINES_A, "  s.cnt_a = 0;\n"), (_LINES_B, "  s.cnt_b = 0;\n"),
                             (_LINES_C, "  s.cnt_c = 0;\n")], ("K2",)),
    "K2 two rows a thread of C": ("two loads in flight a thread at the row ends",
                                  "refresh_ghosts.cu",
                                  [(_K2_ROWS, _K2_ROWS.replace("1;", "2;"))], ("K2",)),
    "K2 four rows a thread of C": ("four loads in flight a thread at the row ends",
                                   "refresh_ghosts.cu",
                                   [(_K2_ROWS, _K2_ROWS.replace("1;", "4;"))], ("K2",)),
    "K2 at most 64 registers": ("four blocks an SM", "refresh_ghosts.cu",
                                [(_K2_BOUNDS, _K2_BOUNDS.replace("(kThreads, 6)", "(kThreads, 4)"))],
                                ("K2",)),
    "K2 at most 32 registers": ("eight blocks an SM", "refresh_ghosts.cu",
                                [(_K2_BOUNDS, _K2_BOUNDS.replace("(kThreads, 6)", "(kThreads, 8)"))],
                                ("K2",)),
    "K4 flat pass only": ("the strip rows' nodes left out", "fold_ghosts.cu",
                          [(_K4_NODES, "  if (a.flat_blocks != 0) return;\n" + _K4_NODES)],
                          ("K4",)),
    "K4 strip rows only": ("the flat pass left out", "fold_ghosts.cu",
                           [(_K4_FLAT, _K4_FLAT + "    if (a.cnt_planes != 0) return;\n")],
                           ("K4",)),
    "K4 flat blocks first": ("the flat pass's blocks, then the strip rows'", "fold_ghosts.cu",
                             [(_K4_FLAT, _K4_FIRST),
                              (_K4_NODES, _K4_NODES.replace("before", "a.flat_blocks"))],
                             ("K4",)),
    "K4 four vectors a thread": ("64 bytes in flight a thread", "fold_ghosts.cu",
                                 [(_K4_VECTORS, _K4_VECTORS.replace("8;", "4;"))], ("K4",)),
    "K4 at most 64 registers": ("four blocks an SM", "fold_ghosts.cu",
                                [(_K4_BOUNDS, _K4_BOUNDS.replace("(kThreads)", "(kThreads, 4)"))],
                                ("K4",)),
    "K7 one block an SM": ("a grid of the SM count", "refresh_ghosts.cu",
                           [(_K7_BLOCKS, _K7_BLOCKS.replace("4;", "1;"))], ("K7", "K7 2D")),
    "K7 two blocks an SM": ("a grid of twice the SM count", "refresh_ghosts.cu",
                            [(_K7_BLOCKS, _K7_BLOCKS.replace("4;", "2;"))], ("K7", "K7 2D")),
    "K7 eight blocks an SM": ("a grid of eight times the SM count", "refresh_ghosts.cu",
                              [(_K7_BLOCKS, _K7_BLOCKS.replace("4;", "8;"))], ("K7", "K7 2D")),
    "K7 16 blocks an SM": ("a grid of 16 times the SM count", "refresh_ghosts.cu",
                           [(_K7_BLOCKS, _K7_BLOCKS.replace("4;", "16;"))], ("K7", "K7 2D")),
    "K7 full grid": ("a block for every 256 threads of the gated-on work, each exiting at "
                     "once when gated off", "refresh_ghosts.cu",
                     [(_K7_CAP, "  blocks = static_cast<unsigned>(need);\n")], ("K7", "K7 2D")),
    "K7 at most 48 registers": ("five blocks an SM, a grid of five times the SM count",
                                "refresh_ghosts.cu",
                                [(_K7_BOUNDS, _K7_BOUNDS.replace("(kThreads, 4)", "(kThreads, 5)")),
                                 (_K7_BLOCKS, _K7_BLOCKS.replace("4;", "5;"))], ("K7",)),
    "K7 at most 40 registers": ("K2's register cap, six blocks an SM, a grid of six times the "
                                "SM count (the first design)", "refresh_ghosts.cu",
                                [(_K7_BOUNDS, _K7_BOUNDS.replace("(kThreads, 4)", "(kThreads, 6)")),
                                 (_K7_BLOCKS, _K7_BLOCKS.replace("4;", "6;"))], ("K7",)),
    "K7 at most 40 registers, 24 blocks an SM": (
        "K2's register cap, a grid of 24 times the SM count", "refresh_ghosts.cu",
        [(_K7_BOUNDS, _K7_BOUNDS.replace("(kThreads, 4)", "(kThreads, 6)")),
         (_K7_BLOCKS, _K7_BLOCKS.replace("4;", "24;"))], ("K7",)),
    "K5 a block for one": ("a block a seam block or a chunk: a grid of both counts",
                           "fold_ghosts.cu",
                           [(_K5_BLOCK, """  if (blockIdx.x < a.seam_blocks)
    zero_seams(buf, a, blockIdx.x);
  else
    zero_chunk(buf, a, blockIdx.x - a.seam_blocks);
"""), (_K5_GRID, "  const int64_t blocks = seam_blocks + long_blocks;\n")], ("K5", "K5 2D")),
    "K5 seams, then the long gaps, eight blocks an SM": (
        "a grid of 1056 blocks (an H100's 132 SMs) walking every seam block, then every chunk",
        "fold_ghosts.cu",
        [(_K5_BLOCK, """  for (uint32_t b = blockIdx.x; b < a.seam_blocks; b += gridDim.x)
    zero_seams(buf, a, b);
  for (uint32_t b = blockIdx.x; b < a.long_blocks; b += gridDim.x) zero_chunk(buf, a, b);
"""), (_K5_GRID, "  const int64_t blocks = 1056;\n")], ("K5", "K5 2D")),
    "K5 four vectors a thread": ("chunks of 4 x 256 vectors", "fold_ghosts.cu",
                                 [(_K5_VECTORS, _K5_VECTORS.replace("1;", "4;"))], ("K5", "K5 2D")),
    "K5 a thread a seam": ("six stores a thread", "fold_ghosts.cu",
                           [(_K5_LANES, _K5_LANES.replace("6;", "1;"))], ("K5", "K5 2D")),
    "K5 a thread two seams": ("two seams a thread, kThreads apart", "fold_ghosts.cu",
                              [(_K5_LANES, _K5_LANES.replace("6;", "1;")),
                               (_K5_SEAMS, _K5_SEAMS.replace("1;", "2;"))], ("K5", "K5 2D")),
    "K5 a thread four seams": ("four seams a thread", "fold_ghosts.cu",
                               [(_K5_LANES, _K5_LANES.replace("6;", "1;")),
                                (_K5_SEAMS, _K5_SEAMS.replace("1;", "4;"))], ("K5", "K5 2D")),
    "K5 two lanes a seam": ("three stores a lane", "fold_ghosts.cu",
                            [(_K5_LANES, _K5_LANES.replace("6;", "2;"))], ("K5", "K5 2D")),
    "K5 three lanes a seam": ("two stores a lane", "fold_ghosts.cu",
                              [(_K5_LANES, _K5_LANES.replace("6;", "3;"))], ("K5", "K5 2D")),
    "K5 six lanes a seam, two items a thread": ("a store a lane, two a thread",
                                                 "fold_ghosts.cu",
                                                 [(_K5_SEAMS, _K5_SEAMS.replace("1;", "2;"))],
                                                 ("K5", "K5 2D")),
    "K5 two vectors a thread": ("chunks of 2 x 256 vectors", "fold_ghosts.cu",
                                [(_K5_VECTORS, _K5_VECTORS.replace("1;", "2;"))], ("K5", "K5 2D")),
    "K5 long gaps only": ("the seams left out", "fold_ghosts.cu",
                          [(_K5_SEAMS_CALL, "")], ("K5", "K5 2D")),
    "K5 seams only": ("the long gaps left out (their blocks exit)", "fold_ghosts.cu",
                      [(_K5_CHUNK_CALL, "")], ("K5", "K5 2D")),
    "K2ax axis 2 a thread a row": ("a padded row's six ghosts a thread", "refresh_ghosts.cu",
                                   [(_AX_SEAMS, _AX_ROW_THREADS),
                                    (_AX_BLOCKS, _AX_BLOCKS.replace("a.lines / kRowSeams + 1",
                                                                    "(a.lines + kThreads - 1) / kThreads"))],
                                   ("K2ax",)),
}


class _Lib:
    """K2's, K4's, K5's and K7's entries of one variant's library, beside the
    main library's others."""

    def __init__(self, path, main):
        lib = ctypes.CDLL(str(path))
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for attr, name, args in (("refresh", "lsm_refresh_ghosts", [vp] + [i64] * 3 + [vp] * 4),
                                 ("fold", "lsm_fold_ghosts", [vp, vp] + [i64] * 3 + [vp] * 4),
                                 ("band_refresh", "lsm_refresh_band_ghosts",
                                  [vp] + [i64] * 3 + [vp] * 5),
                                 ("band_refresh_2d", "lsm_refresh_band_ghosts_2d",
                                  [vp] + [i64] * 2 + [vp] * 5),
                                 ("zero_shells", "lsm_zero_shells", [vp] + [i64] * 3 + [vp]),
                                 ("zero_shells_2d", "lsm_zero_shells_2d", [vp] + [i64] * 2 + [vp]),
                                 ("refresh_axis", "lsm_refresh_axis",
                                  [vp] + [i64] * 3 + [ci] + [vp] * 4),
                                 ("refresh_table", "lsm_refresh_table",
                                  [vp, ci] + [i64] * 3 + [ci, ci] + [vp] * 4 + [ci, vp, vp]),
                                 ("fold_table", "lsm_fold_table",
                                  [vp, vp, ci] + [i64] * 3 + [vp] * 4 + [ci, vp])):
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}", None)
                if fn is None:
                    fn = getattr(main, f"{attr}_{suffix}")
                else:
                    fn.argtypes, fn.restype = args, ci
                setattr(self, f"{attr}_{suffix}", fn)
        self._lib, self.error_string = lib, main.error_string


def build(main, names):
    """The libraries of the variants ``names``, built in parallel: ``{name:
    _Lib}``."""
    out_dir = _build.BUILD_DIR / "shell_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, cmds = _build.find_nvcc(), {}
    for n, (name, (_, source, subs, _)) in enumerate(VARIANTS.items()):
        if source is None or name not in names:
            continue
        src = (_build.CSRC / source).read_text()
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its anchor is not in the source once")
            src = src.replace(old, new)
        cu = out_dir / f"v{n}.cu"
        cu.write_text(src)
        cmds[name] = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
                      str(out_dir / f"libv{n}.so"), str(cu)]
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True) for name, cmd in cmds.items()}
    libs = {"as built": main}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{log[-4000:]}")
        libs[name] = _Lib(cmds[name][-2], main)
        lines = log.splitlines()
        regs = [" ".join(lines[n + 1:n + 3]) for n, line in enumerate(lines)
                if "Compiling entry" in line and any(
                    k in line for k in ("refresh_3d_kernel", "fold_kernel", "zero_shells_kernel",
                                        "refresh_axis_kernel", "refresh_3d_table_kernel",
                                        "band_refresh_3d_table_kernel"))]
        print(f"BUILD {name}: " + " | ".join(regs), flush=True)
    return libs


def main(only) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("shell_variants: no CUDA device")
    unknown = set(only) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"shell_variants: unknown variants {sorted(unknown)}")
    names = ["as built", *(n for n in VARIANTS if n in only)] if only else list(VARIANTS)
    dev = torch.device("cuda", 0)
    libs = build(_build.load_library(), names)
    _, phi, _ = cs.zalesak(cs.N_MAIN, dev)
    torus = cs.torus_field(cs.N_MAIN, dev)
    mixed7 = lsm.normalize_bcs([(lsm.Extrapolation(7), lsm.Symmetry()), lsm.Periodic(),
                                (lsm.Symmetry(), lsm.Extrapolation(5))], 3)
    states = {"periodic": (phi.values, phi.bcs), "extrap2": (torus.values, torus.bcs),
              "mixed7": (phi.values, mixed7)}
    calls = {}
    for label, (values, bcs) in states.items():
        shape = tuple(values.shape)
        P = v2.pack_padded(values, bcs)
        G = torch.randn(v2.padded_shape(shape),
                        generator=torch.Generator(device=dev).manual_seed(8), device=dev)
        calls[("K2", label)] = lambda P=P, bcs=bcs, shape=shape: v2.refresh_ghosts_fast(
            P, bcs, shape)
        calls[("K4", label)] = lambda G=G, bcs=bcs, shape=shape: bwd.fold_ghost_cotangent_fast(
            G, bcs, shape)
    on = torch.ones(2, dtype=torch.int32, device=dev)
    off = torch.zeros(2, dtype=torch.int32, device=dev)
    degree8 = lsm.normalize_bcs(lsm.Extrapolation(8), 3)  # the table route
    s8 = tuple(phi.values.shape)
    P8 = v2.pack_padded(phi.values, degree8)
    G8 = torch.randn(v2.padded_shape(s8),
                     generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    calls[("K2 table", "degree8")] = lambda: v2.refresh_ghosts_fast(P8, degree8, s8)
    calls[("K4 table", "degree8")] = lambda: bwd.fold_ghost_cotangent_fast(G8, degree8, s8)
    for label, f in (("on", on), ("off", off)):
        calls[("K7 table", label)] = lambda f=f: bd.refresh_band_ghosts_fast(P8, degree8, s8, f)
    del phi, torus, states
    nb = cs.sphere_band(cs.N_MAIN, dev)
    _, nb2, _ = cs.d2b(cs.N_2D, dev)
    for kernel, b in (("K7", nb), ("K7 2D", nb2)):
        Q = v2.pack_padded(b.values, b.bcs)
        for label, f in (("on", on), ("off", off)):
            calls[(kernel, label)] = lambda Q=Q, b=b, f=f: bd.refresh_band_ghosts_fast(
                Q, b.bcs, b.shape, f)
    del nb, nb2
    gen = torch.Generator(device=dev).manual_seed(5)
    for kernel, shape in (("K5", (cs.N_MAIN,) * 3), ("K5 2D", (cs.N_2D,) * 2)):
        Z = torch.randn(v2.padded_shape(shape), generator=gen, device=dev)
        calls[(kernel, "f32")] = lambda Z=Z, shape=shape: bwd.zero_pad_shells(Z, shape)
    periodic = lsm.normalize_bcs(lsm.Periodic(), 3)
    for ms, axes in (((2, 2), (2,)), ((4, 1), (1, 2))):
        shape = (cs.N_MAIN // ms[0], cs.N_MAIN // ms[1], cs.N_MAIN)
        bufs = [torch.zeros(v2.padded_shape(shape), device=dev) for _ in range(cs.K9_SETS)]
        for ax in axes:
            it = itertools.cycle(bufs)
            calls[("K2ax", f"{ms[0]}x{ms[1]} axis {ax}")] = (
                lambda it=it, shape=shape, ax=ax: v2.refresh_axis_fast(next(it), periodic, shape,
                                                                      ax))
    times = {name: {} for name in names}
    loaders = v2.load_library, bwd.load_library, bd.load_library
    try:
        for name in [*names, *reversed(names)]:
            v2.load_library = bwd.load_library = bd.load_library = lambda lib=libs[name]: lib
            for (kernel, label), fn in calls.items():
                if kernel not in VARIANTS[name][3]:
                    continue
                for key, ms in ((f"{kernel} {label} device", cs.device_ms(fn)),
                                (f"{kernel} {label} event", cs.cuda_time(fn))):
                    times[name][key] = min(times[name].get(key, ms), ms)
    finally:
        v2.load_library, bwd.load_library, bd.load_library = loaders
    print(cs.nvidia_smi())
    for name in names:
        what = VARIANTS[name][0]
        print(f"VARIANT {name} ({what}): "
              + " ".join(f"{k} {v:.4f} ms" for k, v in times[name].items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
