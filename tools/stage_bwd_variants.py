"""What binds the stage adjoint: K3, K3'' and K3' timed at 512^3 f32 with
parts of `lsm_tpu_torch/csrc/stage_backward.cu` taken out or changed.

Each variant is the source with a text substitution, built by nvcc (the
port's flags) into a library of its own under `lsm_tpu_torch/_build/`; the
wrappers of `ops/weno_v2_bwd.py` launch it on the smoke's inputs (K3 on the
flagship's streamed stage 1, K3'' with the rotation in-kernel, K3' on
configs A and C). A variant that removes work computes something else:
only its time is read. Variants run in turns (all, then all in reverse) and
each line gives the faster of a variant's two CUDA-event medians.

From the repository root, on a machine with one H100:
    python3 tools/stage_bwd_variants.py
"""

from __future__ import annotations

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


#: name: (what it shows, substitutions, extra nvcc flags, kernels it touches)
VARIANTS = {
    "as built": ("the kernels", [], (), ("K3", "K3''", "K3' A", "K3' C")),
    "K3 without WENO5 arithmetic": (
        "K3's adjoints replaced by a product per difference: the skeleton",
        [(_AXIS0, _cheap(_AXIS0)), (_AXES12, _cheap(_AXES12))], (), ("K3", "K3''")),
    "K3 without axis 0": (
        "the compile-time switch kAxis0 off",
        [("stage_bwd_kernel<T, kProgram, true>;", "stage_bwd_kernel<T, kProgram, false>;")], (),
        ("K3", "K3''")),
    "no FMA": ("the file built with -fmad=false", [], ("-fmad=false",),
               ("K3", "K3''", "K3' A", "K3' C")),
    "K3' IEEE sqrt and division": (
        "K3''s float square roots and quotients IEEE",
        [("__device__ __forceinline__ float tsqrt(float x) { return x > 0.0f ? x * rsqrtf(x) : "
          "0.0f; }", "__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }"),
         ("__device__ __forceinline__ float qdiv(float a, float b) { return __fdividef(a, b); }",
          "__device__ __forceinline__ float qdiv(float a, float b) { return a / b; }")], (),
        ("K3' A", "K3' C")),
    "K3' without the Godunov adjoint": (
        "its pieces zero", [("godunov_adjoint<T, kProgram>(a, S, q, Y, gbar, centre, o);",
                             "o = GodAdj<T>{};")], (), ("K3' A", "K3' C")),
    "K3' without the curvature adjoint": (
        "its pieces zero", [("curvature_adjoint<T, kProgram>(a, S, q, Y, gbar, centre, o);",
                             "o = CurvAdj<T>{};")], (), ("K3' A",)),
    "K3' without the gather": (
        "phase 2's loops off",
        [("      for (int d = 1; d < 3; ++d) {", "      for (int d = 1; d < 3 && a.chunk < 0; ++d) {"),
         ("        for (int m = 0; m < 3; ++m) {",
          "        for (int m = 0; m < 3 && a.chunk < 0; ++m) {")], (), ("K3' A", "K3' C")),
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
                ("stage_bwd_prog", "lsm_stage_bwd_prog", [vp] * 7 + [i64] * 3 + [vp, ci, ci, vp])):
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes, fn.restype = args, ci
                setattr(self, f"{attr}_{suffix}", fn)
        for name in ("stage_bwd_scratch", "stage_bwd_terms_scratch"):
            fn = getattr(lib, f"lsm_{name}")
            fn.argtypes, fn.restype = [i64] * 3, i64
            setattr(self, name, fn)
        self._lib, self.error_string = lib, main.error_string


def build(main):
    """Every variant's library, built in parallel: ``{name: _Lib}``."""
    out_dir = _build.BUILD_DIR / "stage_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text, nvcc, cmds = SOURCE.read_text(), _build.find_nvcc(), {}
    for n, (name, (_, subs, flags, _)) in enumerate(VARIANTS.items()):
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stage_bwd_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build(_build.load_library())
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
    times = {name: {} for name in VARIANTS}
    loader = bwd.load_library
    try:
        for name in [*VARIANTS, *reversed(VARIANTS)]:
            bwd.load_library = lambda lib=libs[name]: lib
            for kernel in VARIANTS[name][3]:
                ms = cs.cuda_time(calls[kernel], warmup=2, reps=10)
                times[name][kernel] = min(times[name].get(kernel, ms), ms)
    finally:
        bwd.load_library = loader
    print(cs.nvidia_smi())
    for name, (what, *_rest) in VARIANTS.items():
        print(f"VARIANT {name} ({what}): "
              + " ".join(f"{k} {v:.4f} ms" for k, v in times[name].items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
