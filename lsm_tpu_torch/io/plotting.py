"""Plotting of level sets (port of :mod:`lsm_tpu.io.plotting`; matplotlib).

2D: the zero contour, the filled interior and, for a narrow band, the active
nodes shaded; 3D: an isosurface preview from the native marching tetrahedra.
Figures are written to files (headless hosts). Plotting is host code: a
field on the card is read back first, and matplotlib is imported only when a
plot is drawn.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.field import MeshField
from ..core.narrowband import NarrowBandField
from .marching import host_values, marching_tetrahedra, weld_triangles

__all__ = ["plot_levelset", "save_plot"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_levelset(
    phi: MeshField,
    ax=None,
    *,
    fill: bool = True,
    show_band: bool = True,
    cmap: str = "RdBu",
):
    """Plot a 2D level set: filled interior, zero contour, and (for a narrow
    band) the active-node mask. Returns the matplotlib axis."""
    if phi.ndim != 2:
        raise ValueError("plot_levelset draws 2D fields; use export_surface_mesh in 3D")
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    x = phi.grid.axis_coords(0, device="cpu").numpy()
    y = phi.grid.axis_coords(1, device="cpu").numpy()
    vals = host_values(phi)
    if fill:
        ax.contourf(
            x, y, vals.T, levels=[-np.inf, 0.0], colors=["#7fb2d8"], alpha=0.8
        )
    if show_band and isinstance(phi, NarrowBandField):
        mask = phi.active_mask.detach().cpu().numpy().astype(float)
        ax.pcolormesh(
            x, y, np.where(mask.T > 0, 1.0, np.nan), cmap="Greys", alpha=0.15,
            shading="auto", vmin=0, vmax=2,
        )
    ax.contour(x, y, vals.T, levels=[0.0], colors="k", linewidths=1.5)
    ax.set_aspect("equal")
    return ax


def save_plot(phi: MeshField, path, **kwargs) -> Path:
    """Render :func:`plot_levelset` (2D) or an isosurface preview (3D) to
    ``path``."""
    plt = _mpl()
    path = Path(path)
    if phi.ndim == 2:
        ax = plot_levelset(phi, **kwargs)
        ax.figure.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(ax.figure)
        return path
    if phi.ndim == 3:
        tris = marching_tetrahedra(phi)
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        if tris.shape[0]:
            verts, faces = weld_triangles(tris)
            ax.plot_trisurf(
                verts[:, 0], verts[:, 1], faces, verts[:, 2],
                color="#7fb2d8", edgecolor="none", alpha=0.9,
            )
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return path
    raise ValueError("save_plot supports 2D and 3D fields")
