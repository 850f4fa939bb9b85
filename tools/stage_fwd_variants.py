"""What binds the forward stage: K1 (the advection-only streamed entry) and
K1'' (its program entry) timed at 512^3 f32 with the per-axis WENO5 core of
`lsm_tpu_torch/csrc/weno5.cuh` (`weno5_upwind`, which both call) taken out
or changed, and with the march's rows per thread, copies in flight, chunk,
register budget and copy widths changed (`csrc/weno_stage.cu`).

Each variant is a copy of `csrc/weno_stage.cu`, `csrc/coef_tables.cu` and
the headers in a directory of its own, `weno5.cuh` or `weno_stage.cu`
changed by a text substitution, built by nvcc (the port's flags) into a
library of its own under `lsm_tpu_torch/_build/`; the wrapper
`ops/weno_v2.fused_stage` launches it on the smoke's inputs: the 512^3
Zalesak field, the rotation streamed (stage 1, and stage 2 with aux) and
in-kernel, and the vortex in-kernel. A variant that removes work computes
something else: only its time is read. A variant of the march is skipped on
a tree without the march (the parent's kernels) and stops the study where
its text is not in the tree's march; a variant of `weno5.cuh` whose
substitution finds nothing (a reciprocal variant on the other tree) is
skipped. Variants run in turns (all, then all in reverse)
and each line gives the faster of a variant's two CUDA-event medians.
``ncu`` does not run on the card's machine; this study stands in for it.
For the kernels as built it also counts, from ``cuobjdump -sass``, the
instructions of the march's plane loop (the smallest loop around its
barrier) by class: what one thread issues per plane for its rows, counted
statically (both sides of a branch taken at run time, such as the copy
widths, are counted).

K1' (the term-list entry) is timed on configs A and B and on the kinds
gradient's table (`_TERMS`), as built and with `csrc/hamiltonians.cuh`'s
Hamiltonians cut to one sum of their loads ("K1' loads only"), with every
load of phi served from the node's own value ("K1' arithmetic only"), with
its march taken apart step by step ("K1' copies only", "centre only",
"samples only") and with the march's rows a thread, blocks an SM, steps in
flight, stream staging and rounding changed. On the parent of the march
(one thread per node) the first two apply to its header.

From the root of a tree of this repository (the tree's own modules and
kernel sources are used), on a machine with one H100:
    python3 tools/stage_fwd_variants.py [VARIANT ...]
(named variants only, beside "as built"; default all).
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import lsm_tpu_torch as lsm  # noqa: E402
from lsm_tpu_torch.integrators.fused import FusedStepper  # noqa: E402
from lsm_tpu_torch.ops import _build  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402

STAGE = "weno_stage.cu"
MARCH = "march.cuh"  # K1's march (in STAGE on a tree before it)
SOURCES = (STAGE, "coef_tables.cu")
HEADER = "weno5.cuh"
HAMS = "hamiltonians.cuh"

_SIGNATURE = "__device__ __forceinline__ T weno5_upwind(const T* dm, T u) {\n"
_R = "  const T r = T(1.0) / eps;\n"
_W = "  const T w = T(1.0) / (q1 + q2 + q3);\n"
_R_FAST = "  const T r = weno_recip(eps);\n"
_W_FAST = "  const T w = weno_recip(q1 + q2 + q3);\n"
# approximate reciprocal plus one Newton step, in float (the reference's
# _fast_recip); double keeps its division
_FAST = """template <typename T>
__device__ __forceinline__ T variant_recip(T x) {
  if constexpr (sizeof(T) == 4) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r * (2.0f - x * r);
  } else {
    return T(1.0) / x;
  }
}

"""


def _body(text: str, body: str) -> str:
    """``text`` with the body of ``weno5_upwind`` replaced by ``body``."""
    start = text.index(_SIGNATURE) + len(_SIGNATURE)
    return text[:start] + body + text[text.index("\n}\n", start) + 1:]


_KERNELS = ("K1", "K1 aux", "K1'' rotation", "K1'' vortex")
#: K1' on configs A (curvature + normal motion, constants), B (the eikonal
#: term, frozen sign streamed and recomputed) and the kinds gradient's table
#: (curvature constant + normal motion at a streamed speed)
_TERMS = ("K1' A", "K1' B frozen", "K1' B none", "K1' kinds grad")

# K1''s per-node loads of phi: `P[c ...]` in the one-thread-per-node header
_LOAD = re.compile(r"P\[c(?:[^\[\]]|\[[^\]]*\])*\]")
# an opaque copy: the compiler cannot tell two of them equal, so the
# arithmetic on them is not folded or shared
_OPAQUE = """template <typename T>
__device__ __forceinline__ T opaque_(T x) {
  if constexpr (sizeof(T) == 4) {
    asm volatile("" : "+f"(x));
  } else {
    asm volatile("" : "+d"(x));
  }
  return x;
}

"""


def _fn_body(text: str, head: str, body: str) -> str:
    """``text`` with the body of the function whose declaration starts
    with ``head`` replaced by ``body``; ``text`` unchanged without it."""
    if head not in text:
        return text
    start = text.index("{\n", text.index(head)) + 2
    return text[:start] + body + text[text.index("\n}\n", start) + 1:]


def _arith_only(text: str) -> str:
    """Every load of phi by K1''s one-thread-per-node functions served from
    the centre's value (one load a node), each an opaque copy."""
    if "P[c - 2 * s]" not in text:  # not this header's form
        return text
    text = text.replace("namespace lsm {\n", "namespace lsm {\n\n" + _OPAQUE, 1)
    return _LOAD.sub("opaque_(P[c])", text)


# the march's loads of a node's samples from its tile (weno_stage.cu load_nbr)
_RING_LOAD = re.compile(r"(?:own|pl\[[^\]]*\])\[[^\]]*\]")
_LOAD_NBR = "__device__ __forceinline__ void load_nbr("


def _arith_only_march(text: str) -> str:
    """Every sample K1''s march loads from its tile served from the node's
    own, each an opaque copy."""
    if _LOAD_NBR not in text:
        return text
    start = text.index("{\n", text.index(_LOAD_NBR)) + 2
    end = text.index("\n}\n", start)
    body = text[start:end].replace("n.c = own[x];", "n.c = own[x];  // kept")
    body = _RING_LOAD.sub("opaque_(own[x])", body).replace("n.c = opaque_(own[x]);  // kept",
                                                           "n.c = own[x];")
    text = text[:start] + body + text[end:]
    at = text.index("template", text.rindex("\n\n", 0, text.index(_LOAD_NBR)))
    return text[:at] + _OPAQUE + text[at:]


def _loads_only(text: str) -> str:
    """Each Hamiltonian replaced by one sum of the values it loads (ENO2:
    its five samples; Godunov: the axes' sums; curvature: its 19 samples),
    in the one-thread-per-node header's form or the accessor's."""
    if "void eno2(const N& n" in text:
        text = _fn_body(text, "__device__ __forceinline__ void second_diffs(",
                        "#pragma unroll\n  for (int d = kFirst; d < 3; ++d) hd[d] = n.at(d, 1);\n")
        text = _fn_body(text, "__device__ __forceinline__ void eno2(",
                        "  A = ((n.at(d, -2) + n.at(d, -1)) + n.at(d, 0)) + (n.at(d, 1) + n.at(d, 2));\n"
                        "  B = A + d2c;\n")
        text = _fn_body(text, "__device__ __forceinline__ void godunov(",
                        "  T sum = T(0);\n#pragma unroll\n  for (int d = kFirst; d < 3; ++d) {\n"
                        "    T A, B;\n    eno2(n, d, c.inv_h(d), c.half_h(d), c.inv_hh(d), "
                        "hd[d], A, B);\n    sum = sum + B;\n  }\n  gp = sum;\n  gm = sum;\n")
        return _fn_body(text, "__device__ __forceinline__ void curvature(",
                        "  T r = n.at(0, 0);\n#pragma unroll\n"
                        "  for (int d = kFirst; d < 3; ++d) r = r + (n.at(d, 1) + n.at(d, -1));\n#pragma unroll\n"
                        "  for (int k = kFirst == 1 ? 2 : 0; k < 3; ++k)\n"
                        "    r = r + ((n.corner(k, 1, 1) + n.corner(k, 1, -1)) + (n.corner(k, -1, 1) + "
                        "n.corner(k, -1, -1)));\n  kappa = r;\n  norm = T(1);\n")
    text = _fn_body(text, "__device__ __forceinline__ void eno2(",
                    "  A = ((P[c - 2 * s] + P[c - s]) + P[c]) + (P[c + s] + P[c + 2 * s]);\n"
                    "  B = A;\n")
    text = _fn_body(text, "__device__ __forceinline__ void godunov(",
                    "  const int64_t stride[3] = {s0, s1, 1};\n  T sum = T(0);\n"
                    "#pragma unroll\n  for (int d = kFirst; d < 3; ++d) {\n    T A, B;\n"
                    "    eno2(P, c, stride[d], T(p.inv_h[d]), T(p.half_h[d]), T(p.inv_hh[d]), A, B);\n"
                    "    sum = sum + A;\n  }\n  gp = sum;\n  gm = sum;\n")
    return _fn_body(text, "__device__ __forceinline__ T curvature_term(",
                    "  const int64_t st[3] = {s0, s1, 1};\n  T r = P[c];\n#pragma unroll\n"
                    "  for (int d = kFirst; d < 3; ++d) r = r + (P[c + st[d]] + P[c - st[d]]);\n"
                    "  const int pair[3][2] = {{0, 1}, {0, 2}, {1, 2}};\n#pragma unroll\n"
                    "  for (int k = kFirst == 1 ? 2 : 0; k < 3; ++k) {\n"
                    "    const int64_t a = st[pair[k][0]], b2 = st[pair[k][1]];\n"
                    "    r = r + ((P[c + a + b2] + P[c + a - b2]) + (P[c - a + b2] + P[c - a - b2]));\n"
                    "  }\n  return b * r;\n")
_MARCH = "  static constexpr int CX = 32, TY = 8, NT = CX * TY, NR = 2, CY = TY * NR;\n"
_DEPTH = "  static constexpr int DEPTH = sizeof(T) == 4 ? 2 : 1;\n"
_BLOCKS = "  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 2 : 1;"
_PAIRS = "  a.pairs = a.s1 % 2 == 0 &&"
_VEC_U = "  a.vec_u = terms == nullptr &&"
_CHUNK = "constexpr int kChunk = 64;"


_CAP = "  const int cap = room < kMaxStaged ? room : kMaxStaged;"
_NODES = "    if (q < L || k >= a.n2) continue;"
_PIECES = "        pc[r] = lsm::term_pieces<T, kFirst>(n, a.k, pieces);"
_CENTRE = "        pc[r] = lsm::Pieces<T>{n.c, T(0), T(0), T(0), T(0), T(0)};"
_SAMPLES = ("        T sum = n.c;\n#pragma unroll\n        for (int d = kFirst; d < 3; ++d)\n"
            "#pragma unroll\n          for (int m = 0; m < 2 * R; ++m) sum = sum + n.s[d][m];\n"
            "        if (curv)\n#pragma unroll\n          for (int z = kFirst == 0 ? 0 : 8; z < 12; ++z)"
            " sum = sum + n.cr[z / 4][z % 4];\n"
            "        pc[r] = lsm::Pieces<T>{sum, T(0), T(0), T(0), T(0), T(0)};")
# the float square root and division without IEEE rounding (MUFU, no slow
# path); double keeps its IEEE forms
_APPROX = """__device__ __forceinline__ float sqrt_approx_(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ double sqrt_approx_(double x) { return sqrt(x); }
__device__ __forceinline__ float div_approx_(float a, float b) { return __fdividef(a, b); }
__device__ __forceinline__ double div_approx_(double a, double b) { return a / b; }

"""
_TBLOCKS = "  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 2 : 1;"
_TMARCH = "  static constexpr int CX = 32, TY = 8, NT = CX * TY, NR = 4, CY = TY * NR;"
_TDEPTH = "  static constexpr int DEPTH = sizeof(T) == 4 ? (R == 2 ? 3 : 2) : 1;"
def _march(*subs):
    """A change of the march's source: each ``(old, new)`` of ``subs``
    replaced; a text that is not there raises, so a reformat of the source
    cannot quietly shrink the study."""
    def change(text: str) -> str:
        for old, new in subs:
            if old not in text:
                raise ValueError(f"a march variant's text is not in the march: {old.strip()!r}")
            text = text.replace(old, new)
        return text
    return change


#: name: (what it shows, {file: function of its text}, kernels it times). A
#: variant of weno5.cuh whose function leaves it as it is does not apply to
#: this tree and is skipped; one of the march (STAGE) is skipped on a tree
#: without the march.
VARIANTS = {
    "as built": ("the kernels", {}, _KERNELS + _TERMS),
    "skeleton": ("the WENO5 core replaced by a product per difference",
                 {HEADER: lambda s: _body(s, "  T r = u;\n#pragma unroll\n  for (int m = 0; m < 6; "
                                             "++m) r = r * dm[m];\n  return r;\n")}, _KERNELS),
    "divisions as products": ("the two reciprocals replaced by products",
                              {HEADER: lambda s: s.replace(_R, _R_FAST).replace(_W, _W_FAST)
                               .replace(_R_FAST, "  const T r = T(1.0e6) * eps;\n")
                               .replace(_W_FAST, "  const T w = T(0.5) * (q1 + q2 + q3);\n")},
                              _KERNELS),
    "IEEE division": ("the two reciprocals as IEEE divisions (before the fast reciprocal)",
                      {HEADER: lambda s: s.replace(_R_FAST, _R).replace(_W_FAST, _W)}, _KERNELS),
    "fast reciprocal": ("the two divisions as an approximate reciprocal and one Newton step "
                        "(a tree before it)",
                        {HEADER: lambda s: s if _R not in s else s.replace(
                            "template <typename T>\n" + _SIGNATURE,
                            _FAST + "template <typename T>\n" + _SIGNATURE)
                         .replace(_R, "  const T r = variant_recip(eps);\n")
                         .replace(_W, "  const T w = variant_recip(q1 + q2 + q3);\n")},
                        _KERNELS),
    "loads only": ("the core cut to one sum of the differences",
                   {HEADER: lambda s: _body(s, "  return u * (((dm[0] + dm[1]) + (dm[2] + "
                                               "dm[3])) + (dm[4] + dm[5]));\n")}, _KERNELS),
    "one row per thread": ("the march's threads one row each (tile 8 x 32)",
                           {MARCH: _march((_MARCH, _MARCH.replace("NR = 2", "NR = 1")))}, _KERNELS),
    "four rows per thread": ("the march's threads four rows each (tile 32 x 32)",
                             {MARCH: _march((_MARCH, _MARCH.replace("NR = 2", "NR = 4")))}, _KERNELS),
    "registers for three blocks": ("the march's registers sized for 3 blocks of 256 threads",
                                   {MARCH: _march((_BLOCKS, _BLOCKS.replace("? 2", "? 3")))},
                                   _KERNELS),
    "one plane in flight": ("the march's copies one step ahead (f32)",
                            {MARCH: _march((_DEPTH, _DEPTH.replace("? 2", "? 1")))}, _KERNELS),
    "three planes in flight": ("the march's copies three steps ahead (f32)",
                               {MARCH: _march((_DEPTH, _DEPTH.replace("? 2", "? 3")))}, _KERNELS),
    "blocks of 128 threads": ("the march's blocks 4 x 32 threads (tile 8 x 32)",
                              {MARCH: _march((_MARCH, _MARCH.replace("TY = 8", "TY = 4")))},
                              _KERNELS),
    "tile 16 x 64": ("the march's blocks 8 x 64 threads (tile 16 x 64)",
                     {MARCH: _march((_MARCH, _MARCH.replace("CX = 32", "CX = 64")))}, _KERNELS),
    "chunk 128": ("the march's chunk 128 planes",
                  {MARCH: _march((_CHUNK, _CHUNK.replace("64", "128")))},
                  _KERNELS),
    "chunk 32": ("the march's chunk 32 planes",
                 {MARCH: _march((_CHUNK, _CHUNK.replace("64", "32")))},
                 _KERNELS),
    "element copies": ("the tile, aux and velocity copied an element at a time",
                       {STAGE: _march((_PAIRS, "  a.pairs = false &&"),
                                      (_VEC_U, "  a.vec_u = false &&"))}, _KERNELS),
    "K1' loads only": ("K1': each Hamiltonian replaced by one sum of the values it loads",
                       {HAMS: _loads_only}, _TERMS),
    "K1' arithmetic only": ("K1': every load of phi served from the node's own value",
                            {HAMS: _arith_only, STAGE: _arith_only_march}, _TERMS),
    "K1' three blocks": ("K1''s march: registers for 3 blocks of 256 threads (f32; as built 2)",
                         {STAGE: _march((_TBLOCKS, _TBLOCKS.replace("? 2", "? 3")))}, _TERMS),
    "K1' approximate division": ("float square roots and divisions of the Hamiltonians "
                                 "approximate (MUFU; as built IEEE)",
                                 {HAMS: _march(("namespace lsm {\n", "namespace lsm {\n" + _APPROX),
                                               ("{ return sqrt_(x); }", "{ return sqrt_approx_(x); }"),
                                               ("{ return a / b; }", "{ return div_approx_(a, b); }"))},
                                 _TERMS),
    "K1' one row per thread": ("K1''s march: one row a thread (tile 8 x 32; as built four, "
                               "32 x 32)", {STAGE: _march((_TMARCH, _TMARCH.replace("NR = 4",
                                                                                    "NR = 1")))},
                               _TERMS),
    "K1' two rows per thread": ("K1''s march: two rows a thread (tile 16 x 32)",
                                {STAGE: _march((_TMARCH, _TMARCH.replace("NR = 4", "NR = 2")))},
                                _TERMS),
    "K1' two planes in flight": ("K1''s march without advection: copies two steps ahead (f32; "
                                 "as built three)", {STAGE: _march((_TDEPTH, _TDEPTH.replace(
                                     "R == 2 ? 3", "R == 2 ? 2")))}, _TERMS),
    "K1' five planes in flight": ("K1''s march without advection: copies five steps ahead (f32)",
                                  {STAGE: _march((_TDEPTH, _TDEPTH.replace("R == 2 ? 3",
                                                                           "R == 2 ? 5")))},
                                  _TERMS),
    "K1' copies only": ("K1''s march: the copies and barriers alone (no node computed or "
                        "stored)", {STAGE: _march((_NODES, _NODES.replace("k >= a.n2)",
                                                                          "k >= a.n2 || q >= 0)")))},
                        _TERMS),
    "K1' centre only": ("K1''s march without advection: a node's pieces its centre alone (one "
                        "sample loaded), the table walked as built",
                        {STAGE: _march((_PIECES, _CENTRE))}, _TERMS),
    "K1' samples only": ("K1''s march without advection: a node's pieces one sum of the samples "
                         "it loads, the table walked as built", {STAGE: _march((_PIECES, _SAMPLES))},
                         _TERMS),
    "K1' streams in place": ("K1''s march: no stream staged (each read at its node)",
                             {STAGE: _march((_CAP, "  const int cap = 0;"))}, _TERMS),
}


class _Lib:
    """The forward-stage entries of one variant's library, with the argument
    types the tree's own `_build.Library` (``main``) gives them."""

    def __init__(self, path, main):
        lib = ctypes.CDLL(str(path))
        for attr, name in (("stage", "lsm_weno_stage"), ("stage_prog", "lsm_weno_stage_prog"),
                           ("stage_terms", "lsm_weno_stage_terms"),
                           ("prog_tables", "lsm_prog_tables")):
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = getattr(main, f"{attr}_{suffix}").argtypes
                fn.restype = ctypes.c_int
                setattr(self, f"{attr}_{suffix}", fn)
        self._lib, self.error_string, self.log = lib, main.error_string, ""


def build(main, only=()):
    """Every variant's library that applies to this tree (of ``only``, where
    given, and "as built"), built in parallel: ``{name: _Lib}``, each with
    its nvcc output in ``log``."""
    out_dir = _build.BUILD_DIR / "stage_fwd_variants"
    files = [*SOURCES, *(p.name for p in _build.CSRC.glob("*.cuh")), "lsm_kernels.h"]
    nvcc, cmds = _build.find_nvcc(), {}
    has_march = "stage_march_kernel" in (_build.CSRC / STAGE).read_text()
    for n, (name, (_, changes, _)) in enumerate(VARIANTS.items()):
        if only and name not in only and name != "as built":
            continue
        if (STAGE in changes or MARCH in changes) and not has_march and HAMS not in changes:
            print(f"VARIANT {name}: this tree has no march, skipped", flush=True)
            continue
        texts = {f: (_build.CSRC / f).read_text() for f in files}
        if MARCH in changes and MARCH not in texts:  # a tree whose march is in STAGE
            changes = {STAGE: changes[MARCH]}
        new = {f: changes.get(f, lambda s: s)(text) for f, text in texts.items()}
        if changes and new == texts:
            print(f"VARIANT {name}: does not apply to this tree, skipped", flush=True)
            continue
        vdir = out_dir / f"v{n}"
        vdir.mkdir(parents=True, exist_ok=True)
        for f, text in new.items():
            (vdir / f).write_text(text)
        cmds[name] = [nvcc, *_build.NVCC_FLAGS, "-I", str(vdir), "-shared", "-o",
                      str(vdir / "libvariant.so"), *(str(vdir / src) for src in SOURCES)]
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True) for name, cmd in cmds.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{log[-4000:]}")
        libs[name] = _Lib(cmds[name][cmds[name].index("-o") + 1], main)
        libs[name].log = log
    return libs


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;")
_CLASSES = (("FP32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FCHK", "MUFU")),
            ("FP64", ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")),
            ("shared", ("LDS", "STS")), ("cp.async", ("LDGSTS", "LDGDEPBAR", "DEPBAR")),
            ("global", ("LDG", "STG", "LDC", "LDL", "STL")),
            ("integer", ("IADD3", "IMAD", "LEA", "ISETP", "SHF", "LOP3", "SEL", "IABS", "IMNMX",
                         "MOV", "PRMT", "S2R", "CS2R", "I2F", "F2I", "F2F", "P2R", "R2P", "PLOP3",
                         "VIADD", "UIADD3", "ULDC", "UMOV", "USHF", "ULEA", "UIMAD", "S2UR")),
            ("control", ("BRA", "BAR", "EXIT", "BSYNC", "BSSY", "CALL", "RET", "WARPSYNC")))


def loop_mix(lib_path: str):
    """``{kernel: (instructions, {class: count})}`` of the plane loop of each
    march kernel in the library at ``lib_path``: the instructions between the
    target and the source of the shortest backward branch around a
    ``BAR.SYNC`` (static counts; the rows' branches all taken)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for func in text.split("Function : ")[1:]:
        name = func.split(None, 1)[0]
        if "march" not in name:
            continue
        ins = [(int(m.group(1), 16), m.group(2).split()) for m in map(_SASS_LINE.search,
                                                                     func.splitlines()) if m]
        ops = [w[1] if w[0].startswith("@") else w[0] for _, w in ins]
        at = {addr: n for n, (addr, _) in enumerate(ins)}
        bars = [n for n, op in enumerate(ops) if op.startswith("BAR.SYNC")]
        loops = []
        for n, (_, words) in enumerate(ins):
            target = next((w.rstrip(",") for w in reversed(words) if w.startswith("0x")), None)
            if ops[n].startswith("BRA") and target and at.get(int(target, 16), n) < n:
                lo = at[int(target, 16)]
                if any(lo <= b <= n for b in bars):
                    loops.append((n - lo + 1, lo, n))
        if not loops:
            out[name] = (len(ins), {"no loop found; the whole kernel": len(ins)})
            continue
        _, lo, hi = min(loops)
        mix = collections.Counter()
        for op in ops[lo:hi + 1]:
            root = op.split(".")[0]
            mix[next((c for c, roots in _CLASSES if root in roots), "other")] += 1
        out[name] = (hi - lo + 1, dict(mix))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stage_fwd_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build(_build.load_library(), tuple(sys.argv[1:]))
    grid, phi, vel = cs.zalesak(cs.N_MAIN, dev)
    shape, sp = grid.shape, grid.spacing
    P = v2.pack_padded(phi.values, phi.bcs)
    u = tuple(vel.values[d].contiguous() for d in range(3))
    dt = 0.25 * grid.min_spacing
    rot = (cs.program_term("advection", cs.rotation),)
    vortex = (cs.program_term("advection", cs.vortex3),)
    where = v2.Where(grid.lo, None, cs.T_STAGE)
    calls = {"K1": lambda: v2.fused_stage(P, u, (0.0, 1.0, dt), None, sp, shape),
             "K1 aux": lambda: v2.fused_stage(P, u, (0.75, 0.25, 0.25 * dt), P, sp, shape),
             "K1'' rotation": lambda: v2.fused_stage(P, rot, (0.0, 1.0, dt), None, sp, shape,
                                                     where),
             "K1'' vortex": lambda: v2.fused_stage(P, vortex, (0.0, 1.0, dt), None, sp, shape,
                                                   where)}
    for key, wavy, terms_of in (
            ("K1' A", False, lambda f: cs.a_terms()),
            ("K1' B frozen", True, lambda f: (lsm.EikonalReinitializationTerm.from_initial(f),)),
            ("K1' B none", True, lambda f: (lsm.EikonalReinitializationTerm(),)),
            ("K1' kinds grad", False, lambda f: cs.grad_kinds_terms(f, cs.c_term(f).speed.values))):
        f = cs.torus_field(cs.N_MAIN, dev, wavy=wavy)
        sk = FusedStepper(terms_of(f), f, lsm.RK3())
        Pk, tk = sk.pack(f.values), sk.stage_terms(0.0)
        calls[key] = (lambda Pk=Pk, tk=tk, sk=sk: v2.fused_stage(
            Pk, tk, (0.0, 1.0, 1e-4), None, sk.spacing, sk.shape))
    times = {name: {} for name in libs}
    loader = v2.load_library
    try:
        for name in [*libs, *reversed(libs)]:
            v2.load_library = lambda lib=libs[name]: lib
            for kernel in VARIANTS[name][2]:
                ms = cs.cuda_time(calls[kernel], warmup=2, reps=10)
                times[name][kernel] = min(times[name].get(kernel, ms), ms)
    finally:
        v2.load_library = loader
    print(cs.nvidia_smi())
    for name in libs:
        for kernel, info in cs.forward_stage_ptxas(libs[name].log):
            print(f"PTXAS {name}: {kernel}: {info}")
    built = libs["as built"]._lib._name  # the path it was loaded from
    for kernel, (total, mix) in loop_mix(built).items():
        print(f"LOOP {kernel}: {total} instructions a plane per thread: "
              + ", ".join(f"{c} {n}" for c, n in sorted(mix.items(), key=lambda x: -x[1])))
    for name in libs:
        print(f"VARIANT {name} ({VARIANTS[name][0]}): "
              + " ".join(f"{k} {v:.4f} ms" for k, v in times[name].items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
