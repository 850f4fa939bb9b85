"""Surface extraction, mesh export and plotting (host-side; port of
:mod:`lsm_tpu.io`)."""

from .marching import marching_tetrahedra, marching_squares, weld_triangles
from .meshio import export_volume_mesh, export_surface_mesh, write_obj
from .plotting import plot_levelset, save_plot
