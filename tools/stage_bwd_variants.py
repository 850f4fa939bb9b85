"""What binds the stage adjoint: K3, K3'' and K3' timed at 512^3 f32 (with
``--2d``: their 2D marches at 4096^2 f32) with parts of
`lsm_tpu_torch/csrc/stage_backward.cu` taken out or changed.

Each variant is the source with a text substitution, built by nvcc (the
port's flags) into a library of its own under `lsm_tpu_torch/_build/`; the
wrappers of `ops/weno_v2_bwd.py` launch it on the smoke's inputs (K3 on the
flagship's streamed stage 1, K3'' with the rotation in-kernel, K3' on
configs A and C; in 2D the stage inputs of the 2D gradient cells,
`chip_smoke.grad2d_cell`: K3 2D on grad2d_streamed's, K3'' 2D on grad2d's
(the rotation; the vortex with the stage time's cotangent), K3' 2D on
grad2d_kinds'). A variant that removes work computes something else: only
its time is read. Variants run in turns (all, then all in reverse, as many
rounds as ``--rounds`` asks, 2 by default) and each line gives the fastest
of a variant's CUDA-event medians and, in brackets, the slowest: the spread
over the rounds. ``--only`` takes a comma-separated list of variant names
("as built" is always run).

From the repository root, on a machine with one H100:
    python3 tools/stage_bwd_variants.py [--2d] [--rounds N] [--only NAME,NAME]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import lsm_tpu_torch as lsm  # noqa: E402
from lsm_tpu_torch.integrators.fused import FusedStepper  # noqa: E402
from lsm_tpu_torch.ops import _build  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402
from lsm_tpu_torch.ops import weno_v2_bwd as bwd  # noqa: E402

SOURCE = _build.CSRC / "stage_backward.cu"

# K3's two adjoint calls (axis 0; axes 1 and 2) with their stores
_AXIS0 = ("        weno5_fwd_bwd(dm, uv, gup, ddm, core);\n#pragma unroll\n"
          "        for (int q = 0; q < 6; ++q) cz[q] = R::add(cz[q], ddm[q]);")
_AXES12 = ("        weno5_fwd_bwd(dm, uv, gup, ddm, core);\n#pragma unroll\n"
           "        for (int q = 0; q < 6; ++q) Dq[q * dstride] = ddm[q];")
_CHEAP = "        core = uv;\n#pragma unroll\n        for (int q = 0; q < 6; ++q) ddm[q] = dm[q] * gup;\n"


def _cheap(call):
    return call.replace("        weno5_fwd_bwd(dm, uv, gup, ddm, core);\n", _CHEAP)


# the 2D march's two adjoint calls: across the row (axis 1), along the march (axis 0)
_ROW = "        weno5_fwd_bwd(dm, uv, gup, ddm, core);\n        if (m < NR) {"
_MARCH = "        weno5_fwd_bwd(dm, uv, gup, ddm, core);\n        if (y >= i0 && y < i1) {"
_K3_2D = ("K3 2D", "K3'' 2D", "K3'' 2D vortex dt")
_K3K = ("K3' A", "K3' C", "K3' 2D", "K3' 2D program")
_NR = "static constexpr int NR = sizeof(T) == 4 ? 6 : 4;"
_NT = "static constexpr int NT = 128;                    // threads, one column each"
_NTK = "static constexpr int NT = 128, OWN = NT - 4, MIN_BLOCKS = 4;"
_MBK = "static constexpr int MIN_BLOCKS_PROG = sizeof(T) == 4 ? 8 : 4;"
_MB = "  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 3 : 2;"
# the 2D march's copies (P, g, u1, u0, aux), each made conditional on a false test
_COPIES = [(f"{pad}copy_async({dst}", f"{pad}if (a.chunk < 0) copy_async({dst}") for pad, dst in (
    ("        ", "sp + e, a.P"), ("        ", "gd + e, a.g"), ("          ", "gd + NR * WG + e"),
    ("          ", "ud + r * NT + t"), ("          ", "sp + a.aux_at"))]


#: name: (what it shows, substitutions, extra nvcc flags, kernels it touches)
VARIANTS = {
    "as built": ("the kernels", [], (), ("K3", "K3''", "K3' A", "K3' C", *_K3_2D, "K3' 2D",
                                         "K3' 2D program")),
    "K3 without WENO5 arithmetic": (
        "K3's adjoints replaced by a product per difference: the skeleton",
        [(_AXIS0, _cheap(_AXIS0)), (_AXES12, _cheap(_AXES12))], (), ("K3", "K3''")),
    "K3 2D without WENO5 arithmetic": (
        "the 2D march's adjoints a product per difference: its skeleton",
        [(_ROW, _cheap(_ROW)), (_MARCH, _cheap(_MARCH))], (), _K3_2D),
    "K3 2D without axis 1's adjoint": (
        "the adjoints across the row a product per difference", [(_ROW, _cheap(_ROW))], (),
        _K3_2D),
    "K3 2D without axis 0's adjoint": (
        "the adjoints along the march a product per difference", [(_MARCH, _cheap(_MARCH))], (),
        _K3_2D),
    "K3 2D four rows a step": ("NR 4 in f32", [(_NR, _NR.replace("? 6", "? 4"))], (), _K3_2D),
    "K3 2D without its copies": ("the stages' cp.async off (the data garbage)", _COPIES, (),
                                 _K3_2D),
    "K3 2D bare skeleton": ("no copies, the adjoints a product per difference",
                            _COPIES + [(_ROW, _cheap(_ROW)), (_MARCH, _cheap(_MARCH))], (),
                            _K3_2D),
    "K3 2D four blocks an SM": ("a register budget for 4 blocks",
                                [(_MB, _MB.replace("? 3", "? 4"))], (), _K3_2D),
    "K3 2D 64 columns": ("NT 64", [(_NT, _NT.replace("128", "64"))], (), _K3_2D),
    "K3 2D 256 columns": ("NT 256", [(_NT, _NT.replace("128", "256"))], (), _K3_2D),
    "K3' 2D 64 columns": ("its NT 64", [(_NTK, _NTK.replace("128", "64"))], (),
                          ("K3' 2D", "K3' 2D program")),
    "K3' 2D 256 columns": ("its NT 256", [(_NTK, _NTK.replace("128", "256"))], (),
                           ("K3' 2D", "K3' 2D program")),
    "K3' 2D eight blocks an SM": (
        "its register budget for 8 blocks in f32 (64 registers)",
        [(_NTK, _NTK.replace("MIN_BLOCKS = 4", "MIN_BLOCKS = sizeof(T) == 4 ? 8 : 4"))], (),
        ("K3' 2D",)),
    "K3' 2D program four blocks an SM": (
        "the program instantiation's register budget for 4 blocks (128 registers)",
        [(_MBK, _MBK.replace("? 8 : 4", "? 4 : 4"))], (), ("K3' 2D program",)),
    "no FMA": ("the file built with -fmad=false", [], ("-fmad=false",),
               ("K3", "K3''", "K3' A", "K3' C", *_K3_2D, "K3' 2D", "K3' 2D program")),
    "K3' IEEE sqrt and division": (
        "K3''s float square roots and quotients IEEE",
        [("__device__ __forceinline__ float tsqrt(float x) { return x > 0.0f ? x * rsqrtf(x) : "
          "0.0f; }", "__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }"),
         ("__device__ __forceinline__ float qdiv(float a, float b) { return __fdividef(a, b); }",
          "__device__ __forceinline__ float qdiv(float a, float b) { return a / b; }")], (),
        _K3K),
    "K3' without the Godunov adjoint": (
        "its pieces zero", [("godunov_adjoint<T, kProgram, kFirst>(a, S, q, Y, gbar, centre, o);",
                             "o = GodAdj<T>{};")], (), _K3K),
    "K3' without the curvature adjoint": (
        "its pieces zero", [("curvature_adjoint<T, kProgram, kFirst>(a, S, q, Y, gbar, centre, o);",
                             "o = CurvAdj<T>{};")], (), ("K3' A", "K3' 2D", "K3' 2D program")),
    "K3' without the gather": (
        "phase 2's loops off",
        [("  for (int d = kFirst + 1; d < 3; ++d) {",
          "  for (int d = kFirst + 1; d < 3 && kc.dx < T(0); ++d) {"),
         ("    for (int m = kFirst == 0 ? 0 : 2; m < 3; ++m) {",
          "    for (int m = kFirst == 0 ? 0 : 2; m < 3 && kc.dx < T(0); ++m) {")], (), _K3K),
    "K3' without the halo": (
        "phase 1 over the column only",
        [("    for (int e = t; e < RP; e += NT) {\n      const int4 un",
          "    for (int e = t; e < NT; e += NT) {\n      const int4 un")], (), ("K3' A", "K3' C")),
}


class _Lib:
    """The stage-adjoint entries of one variant's library (the argument types
    of `_build.Library`)."""

    def __init__(self, path, main):
        lib = ctypes.CDLL(str(path))
        vp, i64, f64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
        for attr, name, args in (
                ("stage_bwd", "lsm_stage_bwd", [vp] * 13 + [i64] * 3 + [f64] * 6 + [ci, vp]),
                ("stage_bwd_terms", "lsm_stage_bwd_terms", [vp] * 7 + [i64] * 3 + [vp, vp, ci, vp]),
                ("stage_bwd_prog", "lsm_stage_bwd_prog", [vp] * 7 + [i64] * 3 + [vp, ci, ci, vp]),
                ("stage_bwd_2d", "lsm_stage_bwd_2d", [vp] * 11 + [i64] * 2 + [f64] * 5 + [ci, vp]),
                ("stage_bwd_terms_2d", "lsm_stage_bwd_terms_2d",
                 [vp] * 7 + [i64] * 2 + [vp, vp, ci, vp]),
                ("stage_bwd_prog_2d", "lsm_stage_bwd_prog_2d",
                 [vp] * 7 + [i64] * 2 + [vp] + [ci] * 4 + [vp])):
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes, fn.restype = args, ci
                setattr(self, f"{attr}_{suffix}", fn)
        for name in ("stage_bwd_scratch", "stage_bwd_terms_scratch"):
            fn = getattr(lib, f"lsm_{name}")
            fn.argtypes, fn.restype = [i64] * 3, i64
            setattr(self, name, fn)
            fn = getattr(lib, f"lsm_{name}_2d")
            fn.argtypes, fn.restype = [i64] * 2, i64
            setattr(self, f"{name}_2d", fn)
        self._lib, self.error_string = lib, main.error_string


def build(main, variants):
    """Every variant's library, built in parallel: ``{name: _Lib}``."""
    out_dir = _build.BUILD_DIR / "stage_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text, nvcc, cmds = SOURCE.read_text(), _build.find_nvcc(), {}
    for n, (name, (_, subs, flags, _)) in enumerate(variants.items()):
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its anchor is not in the source once")
            src = src.replace(old, new)
        cu = out_dir / f"v{n}.cu"
        cu.write_text(src)
        cmds[name] = [nvcc, *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-shared", "-o",
                      str(out_dir / f"libv{n}.so"), str(cu)]
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True) for name, cmd in cmds.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{log[-4000:]}")
        libs[name] = _Lib(cmds[name][-2], main)
    return libs


def calls_3d(dev):
    """K3, K3'' and K3' (configs A and C) on the 512^3 inputs."""
    n = cs.N_MAIN
    grid, phi, vel = cs.zalesak(n, dev)
    shape, sp = grid.shape, grid.spacing
    fe = FusedStepper(lsm.AdvectionTerm(vel), phi, lsm.ForwardEuler())
    P, u = fe.pack(phi.values), fe.stage_terms(0.0)[0][1]
    coeffs = (0.0, 1.0, 0.5 * float(lsm.compute_cfl(fe.terms, phi, 0.0)))
    G = torch.randn(v2.padded_shape(shape), generator=torch.Generator(device=dev).manual_seed(8),
                    device=dev)
    gf = bwd.fold_ghost_cotangent_fast(G, phi.bcs, shape)
    prog = cs.program_term("advection", cs.rotation)[0].coef_static
    where = v2.Where(grid.lo, None, cs.T_STAGE)
    calls = {"K3": lambda: bwd.stage_backward(P, u, coeffs, None, gf, sp, shape),
             "K3''": lambda: bwd.stage_backward(P, prog, coeffs, None, gf, sp, shape,
                                                where=where)}
    for label in ("A", "C"):
        st, Pk, terms, dt = cs.k3k_inputs(label, n, dev)
        gk = bwd.fold_ghost_cotangent_fast(torch.randn(
            v2.padded_shape(st.shape), generator=torch.Generator(device=dev).manual_seed(14),
            device=dev), st.bcs, st.shape)
        calls[f"K3' {label}"] = (lambda st=st, Pk=Pk, terms=terms, dt=dt, gk=gk:
                                 bwd.stage_backward_terms(Pk, terms, (0.0, 1.0, dt), None, gk,
                                                          st.spacing, st.shape))
    return calls


def calls_2d(dev):
    """K3 2D, K3'' 2D (the rotation; the vortex with dt) and K3' 2D on the
    stage inputs of the 2D gradient cells at N_2D^2 (as tools/grad_2d.py);
    K3' 2D with a program coefficient: a time-dependent program speed beside
    a streamed curvature (the smoke's "K3' program + dt" list) on
    grad2d_kinds' state, with the stage time's cotangent."""
    n = cs.N_2D
    phi, terms_of, _, dt, _ = cs.grad2d_cell("grad2d", n, dev)
    shape, sp = phi.shape, phi.spacing
    G = torch.randn(v2.padded_shape(shape), generator=torch.Generator(device=dev).manual_seed(8),
                    device=dev)
    gf = bwd.fold_ghost_cotangent_fast(G, phi.bcs, shape)
    st = FusedStepper(terms_of(None), phi, lsm.RK3())
    P, prog = st.pack(phi.values), st.entries[0][0].coef_static
    vortex = FusedStepper((lsm.AdvectionTerm(cs.shapes.vortex_velocity(period=4.0)),), phi,
                          lsm.RK3()).entries[0][0].coef_static
    sphi, sterms_of, _, _, _ = cs.grad2d_cell("grad2d_streamed", n, dev)
    u = FusedStepper(sterms_of(None), sphi, lsm.RK3()).entries[0][1]
    kphi, kterms_of, s, kdt, _ = cs.grad2d_cell("grad2d_kinds", n, dev)
    kst = FusedStepper(kterms_of(s), kphi, lsm.RK3())
    KP, kgf = kst.pack(kphi.values), bwd.fold_ghost_cotangent_fast(G, kphi.bcs, shape)
    pst = FusedStepper((lsm.NormalMotionTerm(lambda xs, t: 0.1 + 0.05 * xs[0] + 0.02 * t * xs[1]),
                        lsm.CurvatureTerm(lsm.MeshField(s, kphi.grid))), kphi, lsm.RK3())
    coeffs = (0.0, 1.0, dt)
    return {"K3 2D": lambda: bwd.stage_backward(P, u, coeffs, None, gf, sp, shape),
            "K3'' 2D": lambda: bwd.stage_backward(P, prog, coeffs, None, gf, sp, shape,
                                                  where=v2.Where(st.lo, None, 0.0)),
            "K3'' 2D vortex dt": lambda: bwd.stage_backward(
                P, vortex, coeffs, None, gf, sp, shape, where=v2.Where(st.lo, None, cs.T_STAGE),
                need_dt=True),
            "K3' 2D": lambda: bwd.stage_backward_terms(KP, kst.entries, (0.0, 1.0, kdt), None, kgf,
                                                       kphi.spacing, shape),
            "K3' 2D program": lambda: bwd.stage_backward_terms(
                KP, pst.entries, (0.0, 1.0, kdt), None, kgf, kphi.spacing, shape,
                where=v2.Where(pst.lo, None, cs.T_STAGE), need_dt=True)}


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stage_bwd_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--2d", dest="two_d", action="store_true", help="the 2D marches")
    ap.add_argument("--rounds", type=int, default=2, help="turns, each all variants")
    ap.add_argument("--only", help="comma-separated variant names")
    args = ap.parse_args(argv)
    only = None if args.only is None else {"as built", *args.only.split(",")}
    if only is not None and not only <= set(VARIANTS):
        raise SystemExit(f"stage_bwd_variants: no variant {sorted(only - set(VARIANTS))}")
    calls = calls_2d(dev) if args.two_d else calls_3d(dev)
    variants = {name: (what, subs, flags, tuple(k for k in kernels if k in calls))
                for name, (what, subs, flags, kernels) in VARIANTS.items()
                if only is None or name in only}
    variants = {name: v for name, v in variants.items() if v[3]}
    libs = build(_build.load_library(), variants)
    times = {name: {} for name in variants}
    loader = bwd.load_library
    order = [*variants, *reversed(variants)] * ((args.rounds + 1) // 2)
    try:
        for name in order[:args.rounds * len(variants)]:
            bwd.load_library = lambda lib=libs[name]: lib
            for kernel in variants[name][3]:
                times[name].setdefault(kernel, []).append(
                    cs.cuda_time(calls[kernel], warmup=2, reps=10))
    finally:
        bwd.load_library = loader
    print(cs.nvidia_smi())
    for name, (what, *_rest) in variants.items():
        print(f"VARIANT {name} ({what}): "
              + " ".join(f"{k} {min(v):.4f} ms ({max(v):.4f})" for k, v in times[name].items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
