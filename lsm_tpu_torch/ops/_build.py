"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``lsm_tpu_torch/csrc/*.cu`` into one shared library
with a plain C interface (``csrc/lsm_kernels.h``) for ``sm_90a``; ``ctypes``
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
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "find_nvcc", "compile_library", "load_library", "Library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CUDA_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
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


def compile_library(out: Path, nvcc: str) -> str:
    """Compile the sources into ``out``; returns nvcc's output (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel). Raises
    ``RuntimeError`` carrying the compiler's output when the build fails."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {nvcc}: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return log


class Library:
    """The loaded kernel library: ``stage_f32/f64`` (K1), ``refresh_f32/f64``
    (K2), ``error_string``, plus where it came from (``path``), the build's
    wall time in seconds (``build_seconds``, 0 when it was already built) and
    nvcc's output (``log``)."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path, self.build_seconds, self.log = path, build_seconds, log
        lib = ctypes.CDLL(str(path))
        vp, i64, f64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
        stage_args = [vp] * 6 + [i64] * 3 + [f64] * 6 + [vp]
        refresh_args = [vp] + [i64] * 3 + [vp] * 3 + [vp]
        for name, args in (("lsm_weno_stage_f32", stage_args),
                           ("lsm_weno_stage_f64", stage_args),
                           ("lsm_refresh_ghosts_f32", refresh_args),
                           ("lsm_refresh_ghosts_f64", refresh_args)):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ci
        lib.lsm_error_string.argtypes = [ci]
        lib.lsm_error_string.restype = ctypes.c_char_p
        self._lib = lib
        self.stage_f32 = lib.lsm_weno_stage_f32
        self.stage_f64 = lib.lsm_weno_stage_f64
        self.refresh_f32 = lib.lsm_refresh_ghosts_f32
        self.refresh_f64 = lib.lsm_refresh_ghosts_f64

    def error_string(self, code: int) -> str:
        return self._lib.lsm_error_string(int(code)).decode()


@functools.cache
def load_library() -> Library:
    """Build (first use) and load the kernel library; cached per process."""
    path = BUILD_DIR / f"liblsm_kernels-{_digest()}.so"
    if path.exists():
        return Library(path, 0.0, "already built")
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    log = compile_library(path, nvcc)
    return Library(path, time.perf_counter() - t0, log)
