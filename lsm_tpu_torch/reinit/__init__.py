"""Reinitialization of a level set to a signed distance function, and the
extension of a speed off the interface along normals."""

from .eikonal import reinitialize, reinit_rhs
from .velocity_extension import extend_along_normals
