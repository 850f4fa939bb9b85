"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``lsm_tpu_torch/csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface (``csrc/lsm_kernels.h``); ``ctypes``
loads it. The library lands in ``lsm_tpu_torch/_build/`` under a name keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "find_nvcc", "compile_library", "load_library", "Library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CUDA_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``CUDA_DEFAULT/bin``. Raises ``RuntimeError`` when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append(os.path.join(CUDA_DEFAULT, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        f"nvcc not found (looked in $CUDA_HOME/bin, PATH and {CUDA_DEFAULT}/bin): "
        "the CUDA kernels of lsm_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Start every command at once and wait for all; returns their joined
    output. Raises ``RuntimeError`` carrying the output of the first that
    fails, or when one cannot be started."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    except OSError as e:
        for p in procs:
            p.kill()
            p.wait()
        raise RuntimeError(f"cannot run {cmds[0][0]}: {e}") from e
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def compile_library(out: Path, nvcc: str) -> str:
    """Compile the sources into ``out``: one ``nvcc -c`` per source, run in
    parallel, then one link. Returns nvcc's output (with ``-Xptxas -v``:
    registers, shared memory and spills per kernel). Raises ``RuntimeError``
    carrying the compiler's output when the build fails."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as objdir:
        objs = {src: str(Path(objdir) / f"{src.stem}.o") for src in _sources()}
        log = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC),
                         "-c", "-o", obj, str(src)] for src, obj in objs.items()])
        tmp = Path(objdir) / out.name
        log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs.values()]])
        os.replace(tmp, out)
    return log


class Library:
    """The loaded kernel library: ``stage_f32/f64``, ``stage_prog_f32/f64``
    and ``stage_terms_f32/f64`` (K1: advection-only streamed and program
    entries, term-list entry), their 2D entries ``stage_2d``,
    ``stage_prog_2d`` and ``stage_terms_2d`` (``_f32/_f64``; the last one
    thread per node for any table), ``refresh_f32/f64`` (K2), its 2D
    entry ``refresh_2d_f32/f64`` and ``refresh_axis_f32/f64`` (its
    single-axis entry), ``shell_blocks_f32/f64``
    (K9),
    ``stage_bwd_f32/f64``, ``stage_bwd_prog_f32/f64`` and
    ``stage_bwd_scratch`` (K3, K3″), ``stage_bwd_terms_f32/f64`` and
    ``stage_bwd_terms_scratch`` (K3'), ``fold_f32/f64`` (K4),
    ``zero_shells_f32/f64`` (K5), their 2D entries ``stage_bwd_2d``,
    ``stage_bwd_prog_2d``, ``stage_bwd_terms_2d``, ``fold_2d``,
    ``zero_shells_2d`` (``_f32/_f64``), ``stage_bwd_scratch_2d`` and
    ``stage_bwd_terms_scratch_2d``, ``band_stage_f32/f64``,
    ``band_stage_prog_f32/f64`` and ``band_stage_terms_f32/f64`` (K6),
    ``band_refresh_f32/f64`` (K7),
    ``band_retube_f32/f64`` and ``band_retube_smem`` (K8), their 2D entries
    ``band_stage_2d``, ``band_stage_terms_2d``, ``band_stage_prog_2d``,
    ``band_refresh_2d``, ``band_retube_2d`` (``_f32/_f64``) and
    ``band_retube_smem_2d``,
    ``general_3d_f32/f64`` (K10), ``general_2d_f32/f64`` (K11),
    ``refresh_table_f32/f64`` (K2 and K7 for an extrapolation degree above
    7) and ``fold_table_f32/f64`` (K4's),
    ``prog_tables_f32/f64`` (the program tables of K1″, K3″ and K6″), ``error_string``,
    plus where it came from (``path``), the build's wall time in seconds
    (``build_seconds``, 0 when it was already built) and nvcc's output
    (``log``)."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path, self.build_seconds, self.log = path, build_seconds, log
        lib = ctypes.CDLL(str(path))
        vp, i64, f64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
        stage_args = [vp] * 6 + [i64] * 3 + [f64] * 6 + [vp]
        ghost_args = [vp] + [i64] * 3 + [vp] * 3 + [vp]
        fold_args = [vp, vp] + [i64] * 3 + [vp] * 3 + [vp]
        bwd_args = [vp] * 13 + [i64] * 3 + [f64] * 6 + [ci, vp]
        bwd_terms_args = [vp] * 7 + [i64] * 3 + [vp, vp, ci, vp]
        bwd_prog_args = [vp] * 7 + [i64] * 3 + [vp, ci, ci, vp]
        zero_args = [vp] + [i64] * 3 + [vp]
        band_stage_args = [vp] * 8 + [i64] * 7 + [f64] * 6 + [vp]
        band_ghost_args = [vp] + [i64] * 3 + [vp] * 4 + [vp]
        retube_args = [vp] * 5 + [i64] * 9 + [vp]
        terms_args = [vp] * 3 + [i64] * 3 + [vp, vp]
        prog_args = [vp] * 3 + [i64] * 3 + [vp] + [ci] * 3 + [vp]
        band_terms_args = [vp] * 5 + [i64] * 7 + [vp, vp]
        band_prog_args = [vp] * 5 + [i64] * 7 + [vp] + [ci] * 3 + [vp]
        general_2d_args = [vp] * 5 + [i64] * 2 + [f64] * 5 + [vp]
        band_stage_2d_args = [vp] * 7 + [i64] * 5 + [f64] * 5 + [vp]
        band_terms_2d_args = [vp] * 5 + [i64] * 5 + [vp, vp]
        band_ghost_2d_args = [vp] + [i64] * 2 + [vp] * 4 + [vp]
        retube_2d_args = [vp] * 5 + [i64] * 7 + [vp]
        ghost_2d_args = [vp] + [i64] * 2 + [vp] * 3 + [vp]
        terms_2d_args = [vp] * 3 + [i64] * 2 + [vp, vp]
        prog_2d_args = [vp] * 3 + [i64] * 2 + [vp] + [ci] * 2 + [vp]
        axis_args = [vp] + [i64] * 3 + [ci] + [vp] * 3 + [vp]
        bwd_2d_args = [vp] * 11 + [i64] * 2 + [f64] * 5 + [ci, vp]
        bwd_prog_2d_args = [vp] * 7 + [i64] * 2 + [vp] + [ci] * 4 + [vp]
        bwd_terms_2d_args = [vp] * 7 + [i64] * 2 + [vp, vp, ci, vp]
        fold_2d_args = [vp, vp] + [i64] * 2 + [vp] * 3 + [vp]
        zero_2d_args = [vp] + [i64] * 2 + [vp]
        shell_args = [vp] + [i64] * 3 + [vp] * 4 + [vp]
        names = {"stage": ("lsm_weno_stage", stage_args),
                 "general_3d": ("lsm_weno_general_3d", stage_args),
                 "general_2d": ("lsm_weno_general_2d", general_2d_args),
                 "stage_terms": ("lsm_weno_stage_terms", terms_args),
                 "stage_prog": ("lsm_weno_stage_prog", prog_args),
                 "refresh": ("lsm_refresh_ghosts", ghost_args),
                 "refresh_2d": ("lsm_refresh_ghosts_2d", ghost_2d_args),
                 "stage_2d": ("lsm_weno_stage_2d", general_2d_args),
                 "stage_prog_2d": ("lsm_weno_stage_prog_2d", prog_2d_args),
                 "stage_terms_2d": ("lsm_weno_stage_terms_2d", terms_2d_args),
                 "refresh_axis": ("lsm_refresh_axis", axis_args),
                 "shell_blocks": ("lsm_shell_blocks", shell_args),
                 "stage_bwd": ("lsm_stage_bwd", bwd_args),
                 "stage_bwd_terms": ("lsm_stage_bwd_terms", bwd_terms_args),
                 "stage_bwd_prog": ("lsm_stage_bwd_prog", bwd_prog_args),
                 "fold": ("lsm_fold_ghosts", fold_args),
                 "zero_shells": ("lsm_zero_shells", zero_args),
                 "stage_bwd_2d": ("lsm_stage_bwd_2d", bwd_2d_args),
                 "stage_bwd_prog_2d": ("lsm_stage_bwd_prog_2d", bwd_prog_2d_args),
                 "stage_bwd_terms_2d": ("lsm_stage_bwd_terms_2d", bwd_terms_2d_args),
                 "fold_2d": ("lsm_fold_ghosts_2d", fold_2d_args),
                 "zero_shells_2d": ("lsm_zero_shells_2d", zero_2d_args),
                 "band_stage": ("lsm_band_stage", band_stage_args),
                 "band_stage_terms": ("lsm_band_stage_terms", band_terms_args),
                 "band_stage_prog": ("lsm_band_stage_prog", band_prog_args),
                 "band_refresh": ("lsm_refresh_band_ghosts", band_ghost_args),
                 "band_retube": ("lsm_band_retube", retube_args),
                 "band_stage_2d": ("lsm_band_stage_2d", band_stage_2d_args),
                 "band_stage_terms_2d": ("lsm_band_stage_terms_2d", band_terms_2d_args),
                 "band_stage_prog_2d": ("lsm_band_stage_prog_2d", band_terms_2d_args),
                 "band_refresh_2d": ("lsm_refresh_band_ghosts_2d", band_ghost_2d_args),
                 "band_retube_2d": ("lsm_band_retube_2d", retube_2d_args)}
        for attr, (name, args) in names.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = args
                fn.restype = ci
                setattr(self, f"{attr}_{suffix}", fn)
        table_args = {"refresh_table": [vp, ci] + [i64] * 3 + [ci, ci] + [vp] * 4 + [ci, vp, vp],
                      "fold_table": [vp, vp, ci] + [i64] * 3 + [vp] * 4 + [ci, vp]}
        for attr, args in table_args.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"lsm_{attr}_{suffix}")
                fn.argtypes = args
                fn.restype = ci
                setattr(self, f"{attr}_{suffix}", fn)
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"lsm_prog_tables_{suffix}")
            fn.argtypes = [vp, vp]
            fn.restype = ci
            setattr(self, f"prog_tables_{suffix}", fn)
        for name in ("stage_bwd_scratch", "stage_bwd_terms_scratch"):
            fn = getattr(lib, f"lsm_{name}")
            fn.argtypes = [i64] * 3
            fn.restype = i64
            setattr(self, name, fn)
            fn = getattr(lib, f"lsm_{name}_2d")
            fn.argtypes = [i64] * 2
            fn.restype = i64
            setattr(self, f"{name}_2d", fn)
        lib.lsm_band_retube_smem.argtypes = [i64] * 5
        lib.lsm_band_retube_smem.restype = i64
        self.band_retube_smem = lib.lsm_band_retube_smem
        lib.lsm_band_retube_smem_2d.argtypes = [i64] * 4
        lib.lsm_band_retube_smem_2d.restype = i64
        self.band_retube_smem_2d = lib.lsm_band_retube_smem_2d
        lib.lsm_error_string.argtypes = [ci]
        lib.lsm_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def error_string(self, code: int) -> str:
        return self._lib.lsm_error_string(int(code)).decode()


_LOAD_LOCK = threading.Lock()


@functools.cache
def _load() -> Library:
    path = BUILD_DIR / f"liblsm_kernels-{_digest()}.so"
    if path.exists():
        return Library(path, 0.0, "already built")
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    log = compile_library(path, nvcc)
    return Library(path, time.perf_counter() - t0, log)


def load_library() -> Library:
    """Build (first use) and load the kernel library; cached per process.
    The shards of an in-process mesh call it from several threads: the first
    builds, the others wait for it."""
    with _LOAD_LOCK:
        return _load()
