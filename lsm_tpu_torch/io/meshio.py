"""Mesh export of implicit domains (port of :mod:`lsm_tpu.io.meshio`).

Writes the implicit domain ``{phi < 0}`` / interface ``{phi = 0}`` as MEDIT
``.mesh`` files (the native C++ writer does the I/O, on the field's values
read back to the host in float64), then optionally runs the MMG remesher
binaries when they are installed on the host; MMG stays an optional
subprocess, and nothing of it ships here.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..core.field import MeshField
from .marching import host_values, marching_tetrahedra, native_lib, weld_triangles

__all__ = ["export_volume_mesh", "export_surface_mesh", "write_obj"]


def _mmg_args(hgrad=None, hmin=None, hmax=None, hausd=None):
    args = []
    for flag, v in (("-hgrad", hgrad), ("-hmin", hmin), ("-hmax", hmax), ("-hausd", hausd)):
        if v is not None:
            args += [flag, str(v)]
    return args


def export_volume_mesh(
    phi: MeshField,
    path,
    *,
    run_mmg: bool = False,
    hgrad=None,
    hmin=None,
    hmax=None,
    hausd=None,
) -> Path:
    """Write the grid tetrahedralization + phi as MEDIT ``.mesh``/``.sol``
    (MMG's ``-ls`` implicit-domain input): every grid vertex and six
    tetrahedra a cell. With ``run_mmg=True`` and ``mmg3d_O3`` (or ``mmg3d``)
    on PATH, run the remesher and return its output's path."""
    if phi.ndim != 3:
        raise ValueError("export_volume_mesh requires a 3D field (2D: use contours)")
    path = Path(path)
    mesh_path = path.with_suffix(".mesh")
    sol_path = path.with_suffix(".sol")
    lib = native_lib()
    vals = host_values(phi)
    lo = np.asarray(phi.grid.lo, dtype=np.float64)
    h = np.asarray(phi.grid.spacing, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.lsm_write_volume_mesh(
        str(mesh_path).encode(), str(sol_path).encode(),
        vals.ctypes.data_as(dp), *vals.shape,
        lo.ctypes.data_as(dp), h.ctypes.data_as(dp),
    )
    if rc != 0:
        raise OSError(f"failed to write {mesh_path} (rc={rc})")
    if run_mmg:
        exe = shutil.which("mmg3d_O3") or shutil.which("mmg3d")
        if exe is None:
            raise FileNotFoundError(
                "MMG not found on PATH; install mmg3d_O3 to remesh (the .mesh/.sol "
                "pair was still written)"
            )
        out = path.with_name(path.stem + ".remeshed.mesh")
        subprocess.run(
            [exe, "-ls", "-in", str(mesh_path), "-sol", str(sol_path), "-out", str(out)]
            + _mmg_args(hgrad, hmin, hmax, hausd),
            check=True,
        )
        return out
    return mesh_path


def export_surface_mesh(
    phi: MeshField,
    path,
    *,
    run_mmg: bool = False,
    hausd=None,
    hgrad=None,
) -> Path:
    """Triangulate ``{phi = 0}`` (marching tetrahedra) and write a MEDIT
    surface ``.mesh``; optionally remesh with ``mmgs_O3 -nr`` (or ``mmgs``)."""
    if phi.ndim != 3:
        raise ValueError("export_surface_mesh requires a 3D field")
    tris = marching_tetrahedra(phi)
    if tris.shape[0] == 0:
        raise ValueError("level set has no zero iso-surface to export")
    verts, faces = weld_triangles(tris)
    path = Path(path)
    mesh_path = path.with_suffix(".mesh")
    lib = native_lib()
    v = np.ascontiguousarray(verts, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int64)
    rc = lib.lsm_write_surface_mesh(
        str(mesh_path).encode(),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
    )
    if rc != 0:
        raise OSError(f"failed to write {mesh_path} (rc={rc})")
    if run_mmg:
        exe = shutil.which("mmgs_O3") or shutil.which("mmgs")
        if exe is None:
            raise FileNotFoundError(
                "MMG not found on PATH; install mmgs_O3 to remesh (the raw "
                "triangulation was still written)"
            )
        out = path.with_name(path.stem + ".remeshed.mesh")
        subprocess.run(
            [exe, "-nr", "-in", str(mesh_path), "-out", str(out)] + _mmg_args(hgrad=hgrad, hausd=hausd),
            check=True,
        )
        return out
    return mesh_path


def write_obj(path, verts: np.ndarray, faces: np.ndarray) -> Path:
    """Write a welded triangle mesh as Wavefront OBJ."""
    path = Path(path)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for t in faces:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    return path
