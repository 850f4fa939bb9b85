"""Node-centered fields on a Cartesian grid (port of :mod:`lsm_tpu.core.field`).

``values`` is a dense tensor of shape ``grid.shape`` (scalar field) or
``(ndim, *grid.shape)`` (vector field, leading component axis); the grid and
the normalized boundary conditions ride beside it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .bc import bcs_str, normalize_bcs, pad_ghost
from .device import dtype_str, resolve_device
from .grid import Grid

__all__ = ["MeshField", "sample", "SHARDED_ONLY"]

#: what the single-device engine says when it is handed a sharded field
SHARDED_ONLY = ("a ShardedField runs through the explicit sharded paths of "
                "lsm_tpu_torch.parallel (make_sharded_step, make_sharded_evolve, "
                "make_sharded_fused_rollout); unshard() it for the single-device engine")


class MeshField:
    """Dense node-centered field: ``values`` + ``grid`` and ``bcs``."""

    def __init__(self, values: torch.Tensor, grid: Grid, bcs=None, _normalized=False):
        if not _normalized:
            bcs = normalize_bcs(bcs, grid.ndim)
        self.values = values
        self.grid = grid
        self.bcs = bcs

    @property
    def ndim(self) -> int:
        return self.grid.ndim

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.grid.shape

    @property
    def is_vector(self) -> bool:
        return self.values.ndim == self.grid.ndim + 1

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def spacing(self) -> Tuple[float, ...]:
        return self.grid.spacing

    def has_bcs(self) -> bool:
        return self.bcs is not None

    @property
    def active_mask(self):
        """Boolean active-node mask, or ``None`` when every node is active
        (a dense field; a :class:`~lsm_tpu_torch.core.narrowband.NarrowBandField`
        returns its band)."""
        return None

    def update_band(self) -> "MeshField":
        """Re-tube the narrow band; a no-op on a dense field."""
        return self

    def with_bcs(self, bc, *, replace: bool = False) -> "MeshField":
        """Return a copy with boundary conditions attached."""
        if self.bcs is not None and not replace:
            raise ValueError("field already has boundary conditions")
        return MeshField(self.values, self.grid, normalize_bcs(bc, self.ndim), _normalized=True)

    def with_values(self, values: torch.Tensor) -> "MeshField":
        return MeshField(values, self.grid, self.bcs, _normalized=True)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "MeshField":
        """A field on the same grid with values ``fn(values)``."""
        return self.with_values(fn(self.values))

    def pad(self, width: int) -> torch.Tensor:
        """Ghost-padded values with ``width`` layers on every side (vector
        fields pad the spatial axes only)."""
        if self.bcs is None:
            raise ValueError(
                "field has no boundary conditions; stencils reaching off-grid need them"
            )
        if self.is_vector:
            bcs = ((None, None),) + self.bcs  # axis 0 is the component axis
            return pad_ghost(self.values, bcs, width, axes=range(1, self.values.ndim))
        return pad_ghost(self.values, self.bcs, width)

    def __repr__(self) -> str:
        kind = "vector" if self.is_vector else "scalar"
        nodes = " x ".join(str(n) for n in self.shape)
        return (
            f"MeshField ({kind}, {dtype_str(self.values.dtype)})\n"
            f"  |- grid: {nodes} nodes in R^{self.ndim}\n"
            f"  |- bcs:  {bcs_str(self.bcs)}\n"
            f"  `- device: {self.values.device}"
        )


def sample(
    fn: Callable,
    grid: Grid,
    bc=None,
    dtype=None,
    vector: bool = False,
    device=None,
) -> MeshField:
    """Sample ``fn(*coords)`` at the grid nodes into a :class:`MeshField`.

    ``fn`` receives the broadcastable coordinate tensors and returns one tensor
    (scalar field) or a length-``ndim`` sequence (vector field). The
    parameters are JAX's, in JAX's order, then ``device``. ``dtype``
    defaults to ``torch.get_default_dtype()`` and ``device`` to the card
    (:func:`~lsm_tpu_torch.core.device.resolve_device`: the CPU only when
    asked for with ``device="cpu"``).
    """
    dtype = dtype or torch.get_default_dtype()
    xs = grid.coords(dtype=dtype, device=resolve_device(device))
    out = fn(*xs)

    def full(c):
        c = torch.as_tensor(c, dtype=dtype, device=xs[0].device)
        return torch.broadcast_to(c, grid.shape)

    if vector or isinstance(out, (tuple, list)):
        values = torch.stack([full(c) for c in out], dim=0)
    else:
        values = full(out).contiguous()
    return MeshField(values, grid, bc)
