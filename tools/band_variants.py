"""What binds the band kernels: K6 (the band stage: streamed advection,
K6'' with the rotation in-kernel, K6' on config C's normal motion) and K8
(the incremental re-tube) timed on the band bench's 512^3 f32 sphere band
as built and taken apart.

Each variant is a copy of `csrc/band_stage.cu`, `csrc/band_retube.cu` and
the headers in a directory of its own, changed by text substitutions, built
by nvcc (the port's flags) into a library of its own under
`lsm_tpu_torch/_build/`; the wrappers of `ops/band.py` launch it on the
smoke's inputs. A variant that removes work computes something else: only
its time is read. A variant whose text is not in the tree is skipped.
Variants run in turns (all, then all in reverse) and each line gives the faster of a variant's two
CUDA-event medians (a call's host time to issue included, as
`chip_smoke.cuda_time` measures) beside the device time of a call from
``torch.profiler`` tracing the card alone (every kernel of the call, the
allocations' fills included; run in a process of its own: traced after
other traces in one process, the profiler was seen to under-read). ``ncu`` does not run on the card's machine;
this study stands in for it.

From the root of a tree of this repository (the tree's own modules and
kernel sources are used), on a machine with one H100:
    python3 tools/band_variants.py
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
from lsm_tpu_torch.core.narrowband import box_dilate  # noqa: E402
from lsm_tpu_torch.integrators.band_fused import FusedBandStepper  # noqa: E402
from lsm_tpu_torch.ops import _build  # noqa: E402
from lsm_tpu_torch.ops import band as bd  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402

SOURCES = ("band_stage.cu", "band_retube.cu")
KERNELS = ("K6", "K6''", "K6'", "K8")

# name: (what it shows, {file: [(old, new), ...]})
VARIANTS = {
    "as built": ("the kernels as they are", {}),
    "K6 copy only": (
        "every node copies phi: the tile's loads, mask and store without the stage",
        {"band_stage.cu": [("        if (band_on) {", "        if (false) {"),
                           ("o_t[o] = band_on", "o_t[o] = false")]}),
    "K6 centre only": (
        "every WENO5 sample is the node's own phi: one load a node, the arithmetic kept",
        {"weno5.cuh": [("  for (int m = 0; m < 7; ++m) s[m] = P[c + (m - 3) * stride];",
                        "  for (int m = 0; m < 7; ++m) s[m] = P[c] * T(m + 1);")]}),
    "K8 loads only": (
        "the re-tube's reads of phi and the mask into shared memory, then nothing",
        {"band_retube.cu": [("    // 2. cut cells, stored at their lower corner's row",
                             "    if (threadIdx.x == 0) flags[slot] = p0[0];\n    continue;\n"
                             "    // 2. cut cells, stored at their lower corner's row")]}),
}


class _Lib:
    """The tree's library with its band entries taken from a variant."""

    def __init__(self, path, main):
        self._lib = ctypes.CDLL(path)
        for attr in dir(main):
            if not attr.startswith("_"):
                setattr(self, attr, getattr(main, attr))
        for attr in dir(main):
            if attr.startswith("band_"):
                ref = getattr(main, attr)
                name = getattr(ref, "__name__", None)
                if name is None or not hasattr(self._lib, name):
                    continue
                fn = getattr(self._lib, name)
                fn.argtypes, fn.restype = ref.argtypes, ref.restype
                setattr(self, attr, fn)


def kernels_ms(fn, reps=20) -> float:
    """Device time per call of ``fn`` (ms): the sum of its kernels' time
    from ``torch.profiler`` tracing the card alone (warmed up first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def kernel_split(call, reps=20):
    """``{kernel: device ms a call}`` of every kernel ``call`` launches
    (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def build(main):
    """Every variant's library that applies to this tree: ``{name: _Lib}``."""
    out_dir = _build.BUILD_DIR / "band_variants"
    files = [*SOURCES, *(p.name for p in _build.CSRC.glob("*.cuh")), "lsm_kernels.h"]
    texts = {f: (_build.CSRC / f).read_text() for f in files}
    nvcc, cmds, libs = _build.find_nvcc(), {}, {}
    for n, (name, (_, changes)) in enumerate(VARIANTS.items()):
        new = dict(texts)
        for f, subs in changes.items():
            if all(old in texts[f] for old, _ in subs):
                for old, rep in subs:
                    new[f] = new[f].replace(old, rep)
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
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{log[-4000:]}")
        libs[name] = _Lib(cmds[name][cmds[name].index("-o") + 1], main)
        libs[name].log = log
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("band_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    main_lib = _build.load_library()
    libs = build(main_lib)
    nb = cs.sphere_band(cs.N_MAIN, dev)
    shape, sp, halo = nb.shape, nb.grid.spacing, lsm.NarrowBandField.COMPUTE_HALO
    dt = 0.25 * nb.grid.min_spacing
    fe = FusedBandStepper((lsm.AdvectionTerm(cs.spin),), nb, lsm.ForwardEuler())
    state = fe.pack(nb)
    P, out = state.bufs
    prog = fe.stage_terms(state, 0.0)
    u = tuple(c.contiguous() for c in fe._slot_values(prog[0][0], state, 0.0))
    fc = FusedBandStepper((cs.c_term(nb),), nb, lsm.ForwardEuler())
    sc = fc.pack(nb)
    cterms = fc.stage_terms(sc, 0.0)
    cdt = 0.5 * float(fc.cfl(sc, 0.0)[0])
    cids, count = bd.compact_ids(box_dilate(state.act, 1), fe.total)
    band = state.band.clone()
    calls = {
        "K6": lambda: bd.band_stage(P, out, state.ids, state.band, u, (0.0, 1.0, dt), None, sp,
                                    shape, fe.tiles),
        "K6''": lambda: bd.band_stage(P, out, state.ids, state.band, prog, (0.0, 1.0, dt), None,
                                      sp, shape, fe.tiles, v2.Where(fe.lo)),
        "K6'": lambda: bd.band_stage(sc.bufs[0], sc.bufs[1], sc.ids, sc.band, cterms,
                                     (0.0, 1.0, cdt), None, sp, shape, fc.tiles),
        "K8": lambda: bd.band_retube_incremental(P, band, cids, nb.nlayers, halo, shape,
                                                 fe.tiles, count),
    }
    times = {name: {} for name in libs}
    device = {name: {} for name in libs}  # the profiler's device time a call
    loader = bd.load_library
    try:
        for name in [*libs, *reversed(libs)]:
            lib = libs[name]
            bd.load_library = lambda lib=lib: lib
            for kernel in KERNELS:
                call = calls[kernel]
                ms = cs.cuda_time(call, warmup=2, reps=10)
                times[name][kernel] = min(times[name].get(kernel, ms), ms)
                dev_ms = kernels_ms(call)
                device[name][kernel] = min(device[name].get(kernel, dev_ms), dev_ms)
    finally:
        bd.load_library = loader
    print(cs.nvidia_smi())
    print(f"band 512^3: dispatched tiles {int(state.count)}, K8 candidates {int(count)} of "
          f"{cids.shape[0]} slots")
    for kernel in KERNELS:  # the kernels as built, each launch apart
        split = kernel_split(calls[kernel])
        print(f"SPLIT {kernel}: " + ", ".join(f"{k[:48]} {v:.4f} ms" for k, v in split.items()))
    for name in libs:
        if times[name]:
            print(f"VARIANT {name} ({VARIANTS[name][0]}): "
                  + " ".join(f"{k} {v:.4f} ms (device {device[name][k]:.4f})"
                             for k, v in times[name].items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
