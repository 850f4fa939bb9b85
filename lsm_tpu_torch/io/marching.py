"""Surface and contour extraction through the native C++ helper (port of
:mod:`lsm_tpu.io.marching`).

The PDE path stays on the card; extraction is host code. ``native/marching.cpp``
is compiled here with the C++ compiler directly (the flags of
``native/Makefile``, no ``make``) into ``lsm_tpu_torch/_build/``, under a name
keyed on a digest of the source and the flags, and called through ctypes. A
field on the card is read back to the host, in float64, before the call.

- :func:`marching_tetrahedra` — triangle soup of ``{phi = iso}`` (3D).
- :func:`marching_squares` — contour segments of ``{phi = iso}`` (2D).
- :func:`weld_triangles` — deduplicate the soup into (vertices, faces).
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
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..core.field import MeshField

__all__ = [
    "native_lib",
    "build_native",
    "host_values",
    "marching_tetrahedra",
    "marching_squares",
    "weld_triangles",
]

_PKG = Path(__file__).resolve().parents[1]
NATIVE_SRC = _PKG.parent / "native" / "marching.cpp"
BUILD_DIR = _PKG / "_build"
#: ``native/Makefile``'s CXXFLAGS (warnings aside) and ``-shared``
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def find_cxx() -> str:
    """The C++ compiler: ``$CXX``, then ``c++`` and ``g++`` on ``PATH``.
    Raises ``RuntimeError`` when there is none."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler ($CXX, c++ or g++): the marching helper "
                       f"({NATIVE_SRC}) cannot be built")


def build_native(build_dir=BUILD_DIR) -> Path:
    """Compile ``native/marching.cpp`` into ``build_dir`` unless it is there
    already; returns the library's path. The compiler writes a file of its
    own, which is then renamed into place, so processes that build at the
    same moment leave one whole library. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    src = NATIVE_SRC.read_bytes()
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + src).hexdigest()[:16]
    build_dir = Path(build_dir)
    path = build_dir / f"liblsm_native-{digest}.so"
    if path.exists():
        return path
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=build_dir, prefix=f".{path.name}.", suffix=".tmp")
    os.close(fd)
    try:
        cmd = [find_cxx(), *CXX_FLAGS, "-o", tmp, str(NATIVE_SRC)]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"building the marching helper failed with exit code "
                               f"{out.returncode}:\n{' '.join(cmd)}\n{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    dp, i64 = ctypes.POINTER(ctypes.c_double), ctypes.c_int64
    lib.lsm_marching_tets.restype = i64
    lib.lsm_marching_tets.argtypes = [dp, i64, i64, i64, dp, dp, ctypes.c_double,
                                      ctypes.POINTER(dp)]
    lib.lsm_marching_squares.restype = i64
    lib.lsm_marching_squares.argtypes = [dp, i64, i64, dp, dp, ctypes.c_double,
                                         ctypes.POINTER(dp)]
    lib.lsm_write_volume_mesh.restype = i64
    lib.lsm_write_volume_mesh.argtypes = [ctypes.c_char_p, ctypes.c_char_p, dp,
                                          i64, i64, i64, dp, dp]
    lib.lsm_write_surface_mesh.restype = i64
    lib.lsm_write_surface_mesh.argtypes = [ctypes.c_char_p, dp, i64,
                                           ctypes.POINTER(i64), i64]
    lib.lsm_free.restype = None
    lib.lsm_free.argtypes = [ctypes.c_void_p]
    return lib


_LOAD_LOCK = threading.Lock()


@functools.cache
def _load() -> ctypes.CDLL:
    return _declare(ctypes.CDLL(str(build_native())))


def native_lib() -> ctypes.CDLL:
    """Load the native helper library, building it on first use; cached per
    process."""
    with _LOAD_LOCK:
        return _load()


def host_values(phi: MeshField) -> np.ndarray:
    """The field's values as a C-contiguous float64 numpy array on the host
    (read back from the card; detached from any graph)."""
    return phi.values.detach().to("cpu", torch.float64).contiguous().numpy()


def _as_c(phi: MeshField):
    vals = host_values(phi)
    lo = np.asarray(phi.grid.lo, dtype=np.float64)
    h = np.asarray(phi.grid.spacing, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    # the arrays are returned with their pointers: they must outlive the call
    return (vals, lo, h), vals.ctypes.data_as(dp), lo.ctypes.data_as(dp), h.ctypes.data_as(dp)


def _extract(entry, phi: MeshField, iso: float, shape) -> np.ndarray:
    lib = native_lib()
    keep, pv, plo, ph = _as_c(phi)
    out = ctypes.POINTER(ctypes.c_double)()
    n = getattr(lib, entry)(pv, *keep[0].shape, plo, ph, float(iso), ctypes.byref(out))
    try:
        if n == 0:
            return np.zeros((0, *shape))
        return np.ctypeslib.as_array(out, shape=(n, *shape)).copy()
    finally:
        lib.lsm_free(out)


def marching_tetrahedra(phi: MeshField, iso: float = 0.0) -> np.ndarray:
    """Triangle soup of the iso-surface: array ``(ntris, 3, 3)``."""
    if phi.ndim != 3:
        raise ValueError("marching_tetrahedra requires a 3D field")
    return _extract("lsm_marching_tets", phi, iso, (3, 3))


def marching_squares(phi: MeshField, iso: float = 0.0) -> np.ndarray:
    """Contour segments of the iso-line: array ``(nsegs, 2, 2)``."""
    if phi.ndim != 2:
        raise ValueError("marching_squares requires a 2D field")
    return _extract("lsm_marching_squares", phi, iso, (2, 2))


def weld_triangles(tris: np.ndarray, decimals: int = 9) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate a triangle soup into ``(vertices (nv,3), faces (nt,3))``."""
    flat = tris.reshape(-1, 3)
    key = np.round(flat, decimals)
    verts, inverse = np.unique(key, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3)
    # drop degenerate faces produced by welding
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]
