"""Grid, boundary conditions and fields."""

from .grid import Grid
from .bc import (
    BoundaryCondition, Periodic, Extrapolation, Neumann, LinearExtrapolation,
    Symmetry, normalize_bcs, pad_ghost,
)
from .field import MeshField, sample
from .narrowband import NarrowBandField
