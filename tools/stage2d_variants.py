"""What binds K1's 2D entries (the dense 2D stepper's stage,
`lsm_tpu_torch/csrc/weno_stage_2d.cu`): K1 (D2's rotation streamed), K1''
(D2's rotation, D3's vortex) and K1' (D4's curvature and normal motion)
timed at 4096^2 f32 on each configuration's stage-1 inputs, as built and
with the 2D march's threads a block, rows a chunk, steps in flight and work
changed, beside the per-node form; and K2's 2D entry on D2's buffer.

Each variant is a copy of `csrc/weno_stage_2d.cu`, `csrc/coef_tables.cu` and
the headers in a directory of its own, `weno_stage_2d.cu` changed by a text
substitution (a text that is not there stops the study), built by nvcc (the
port's flags) into a library of its own under `lsm_tpu_torch/_build/`; the
wrapper `ops/weno_v2.fused_stage` launches it. A variant that removes work
computes something else: only its time is read. Variants run in turns (all,
then all in reverse); each line gives the faster of a variant's two
readings of each time: "ms" a call between two CUDA events (the wrapper's
host time included), "b2b" a call of 50 issued back to back (the card's time
whenever the host issues faster than the card runs). For the kernels as
built it also counts the instructions of each march's row loop
(`tools/stage_fwd_variants.py` `loop_mix`, from ``cuobjdump -sass``).

From the root of a tree of this repository, on a machine with one H100:
    python3 tools/stage2d_variants.py [VARIANT ...]
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "tools"))
import chip_smoke as cs  # noqa: E402
import stage_fwd_variants as sfv  # noqa: E402
from lsm_tpu_torch.integrators.fused import FusedStepper  # noqa: E402
from lsm_tpu_torch.ops import _build  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402

STAGE = "weno_stage_2d.cu"
SOURCES = (STAGE, "coef_tables.cu")
_NT = "  static constexpr int NT = 128, CX = NT, NR = 8;\n"
_DEPTH = "  static constexpr int DEPTH = 2;\n"
_ROWS = "constexpr int kRows = 64;"
_BOUNDS = "__global__ void __launch_bounds__(March2<T>::NT)\n    stage_march_2d_kernel("
_OUT = "    T* const out = a.out + int64_t(o0 + kH) * a.s1 + k + kH;\n"
_WENO = ("      T ham = lsm::weno5_upwind(dq + r, u[0]);\n"
         "      ham = ham + lsm::weno5_upwind(d1, u[1]);\n")

#: name: (what it shows, substitutions in STAGE)
VARIANTS = {
    "as built": ("the kernels", ()),
    "threads 64": ("blocks of 64 threads (64 columns)",
                   ((_NT, _NT.replace("128", "64")),)),
    "threads 256": ("blocks of 256 threads (256 columns)",
                    ((_NT, _NT.replace("128", "256")),)),
    "rows a step 2": ("two rows a step", ((_NT, _NT.replace("NR = 8", "NR = 2")),)),
    "rows a step 4": ("four rows a step", ((_NT, _NT.replace("NR = 8", "NR = 4")),)),
    "depth 1": ("copies one step ahead", ((_DEPTH, _DEPTH.replace("2", "1")),)),
    "depth 4": ("copies four steps ahead", ((_DEPTH, _DEPTH.replace("2", "4")),)),
    "rows 32": ("chunks of 32 rows", ((_ROWS, _ROWS.replace("64", "32")),)),
    "six blocks": ("the march's registers capped for six blocks an SM (85)",
                   ((_BOUNDS, _BOUNDS.replace("NT)", "NT, 6)")),)),
    "eight blocks": ("the march's registers capped for eight blocks an SM (64)",
                     ((_BOUNDS, _BOUNDS.replace("NT)", "NT, 8)")),)),
    "four blocks of 256": ("256 threads, registers capped for four blocks an SM (64)",
                           ((_NT, _NT.replace("128", "256")),
                            (_BOUNDS, _BOUNDS.replace("NT)", "NT, 4)")))),
    "rows 128": ("chunks of 128 rows", ((_ROWS, _ROWS.replace("64", "128")),)),
    "skeleton": ("K1, K1'': the WENO5 core replaced by a product per axis",
                 ((_WENO, "      T ham = dq[r] * u[0] + d1[0] * u[1];\n"),)),
    "copies only": ("every entry: the copies, barriers and stores, no node computed",
                    ((_OUT, _OUT + "    if (a.n1 > 0) {\n      for (int r = 0; r < NR; ++r)\n"
                      "        if (o0 + r < i1) out[r * a.s1] = row(r + kH)[0];\n"
                      "      continue;\n    }\n"),)),
}


class _Lib:
    """The 2D stage entries and the program tables of one variant's
    library, with the argument types of the tree's `_build.Library`."""

    def __init__(self, path, main):
        lib = ctypes.CDLL(str(path))
        for attr, name in (("stage_2d", "lsm_weno_stage_2d"),
                           ("stage_prog_2d", "lsm_weno_stage_prog_2d"),
                           ("stage_terms_2d", "lsm_weno_stage_terms_2d"),
                           ("prog_tables", "lsm_prog_tables")):
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = getattr(main, f"{attr}_{suffix}").argtypes
                fn.restype = ctypes.c_int
                setattr(self, f"{attr}_{suffix}", fn)
        self._lib, self.error_string, self.path = lib, main.error_string, str(path)


def build(main, only=()):
    """Every variant's library (of ``only`` and "as built"), built in
    parallel: ``{name: _Lib}``."""
    out_dir = _build.BUILD_DIR / "stage2d_variants"
    files = [*SOURCES, *(p.name for p in _build.CSRC.glob("*.cuh")), "lsm_kernels.h"]
    nvcc, cmds = _build.find_nvcc(), {}
    for n, (name, (_, subs)) in enumerate(VARIANTS.items()):
        if only and name not in only and name != "as built":
            continue
        texts = {f: (_build.CSRC / f).read_text() for f in files}
        for old, new in subs:
            if old not in texts[STAGE]:
                raise ValueError(f"variant {name!r}: its text is not in {STAGE}: {old!r}")
            texts[STAGE] = texts[STAGE].replace(old, new)
        vdir = out_dir / f"v{n}"
        vdir.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():
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
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stage2d_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build(_build.load_library(), tuple(sys.argv[1:]))
    calls, per_node = {}, {}
    for name, key in (("D2s", "K1"), ("D2", "K1'' rotation"), ("D3", "K1'' vortex"),
                      ("D4", "K1' D4")):
        terms, phi, integ = cs.config(name, cs.N_2D, dev)
        st = FusedStepper(terms, phi, integ)
        P, where = st.pack(phi.values), v2.Where(st.lo, None, 0.0)
        tt = st.stage_terms(0.0)
        dt = 0.5 * float(st.cfl(P, 0.0))
        args = (P, tt, (0.0, 1.0, dt), None, st.spacing, st.shape, where)
        calls[key] = lambda args=args: v2.fused_stage(*args)
        per_node[key] = lambda args=args: v2.fused_stage_2d_per_node(*args)
        if name == "D2":
            k2 = lambda P=P, st=st: v2.refresh_ghosts_fast(P, st.bcs, st.shape)
    times = {name: {} for name in libs}
    loader = v2.load_library
    try:
        for name in [*libs, *reversed(libs)]:
            v2.load_library = lambda lib=libs[name]: lib
            for key, fn in calls.items():
                for what, ms in (("ms", cs.cuda_time(fn, warmup=2, reps=10)),
                                 ("b2b", cs.back_to_back_ms(fn))):
                    k = f"{key} {what}"
                    times[name][k] = min(times[name].get(k, ms), ms)
    finally:
        v2.load_library = loader
    print(cs.nvidia_smi())
    for kernel, (total, mix) in sfv.loop_mix(libs["as built"].path).items():
        if "2d" in kernel:
            print(f"LOOP {kernel}: {total} instructions a row per thread: "
                  + ", ".join(f"{c} {n}" for c, n in sorted(mix.items(), key=lambda x: -x[1])))
    for key, fn in per_node.items():
        print(f"PER NODE {key}: ms {cs.cuda_time(fn):.4f} b2b {cs.back_to_back_ms(fn):.4f} "
              f"device {cs.device_ms(fn):.4f}")
    for key, fn in calls.items():
        print(f"AS BUILT {key}: device {cs.device_ms(fn):.4f}")
    print(f"K2 2D: ms {cs.cuda_time(k2):.4f} b2b {cs.back_to_back_ms(k2):.4f} "
          f"device {cs.device_ms(k2):.4f}")
    # the host's share of a K2 2D call: its wrapper's pieces, microseconds a call
    P2, bcs2, shape2 = k2.__defaults__[0], k2.__defaults__[1].bcs, k2.__defaults__[1].shape

    def device_context():
        with torch.cuda.device(P2.device):
            pass

    for what, fn in (("the whole wrapper", k2),
                     ("_check", lambda: v2._check(P2, "padded", v2.padded_shape(shape2))),
                     ("_ghost_args", lambda: v2._ghost_args(bcs2, shape2)),
                     ("load_library", _build.load_library),
                     ("torch.cuda.device", device_context),
                     ("current_stream", lambda: torch.cuda.current_stream().cuda_stream)):
        fn()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        torch.cuda.synchronize()
        print(f"HOST {what}: {(time.perf_counter() - t0) * 1e3:.2f} us a call")
    for name in libs:
        print(f"VARIANT {name} ({VARIANTS[name][0]}): "
              + " ".join(f"{k} {v:.4f}" for k, v in times[name].items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
