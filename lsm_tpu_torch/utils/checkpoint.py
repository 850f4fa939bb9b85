"""Checkpoint / resume of level-set evolutions (port of
:mod:`lsm_tpu.utils.checkpoint`), in the same format: a compressed ``.npz``
holding the arrays plus a JSON manifest (``format: 1``) of the grid, BCs and
time. A dense or a narrow-band field (kind ``"narrowband"``: the values, the
active mask and ``nlayers``) saved by either package loads in the other
unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.bc import Extrapolation, Periodic, Symmetry
from ..core.device import resolve_device
from ..core.field import MeshField
from ..core.grid import Grid
from ..core.narrowband import NarrowBandField

__all__ = ["save_checkpoint", "load_checkpoint", "field_from_numpy", "narrowband_from_numpy"]

_FORMAT_VERSION = 1


def _bc_to_json(bcs) -> Optional[list]:
    if bcs is None:
        return None
    out = []
    for left, right in bcs:
        pair = []
        for b in (left, right):
            if isinstance(b, Periodic):
                pair.append({"kind": "periodic"})
            elif isinstance(b, Extrapolation):
                pair.append({"kind": "extrapolation", "degree": b.degree})
            elif isinstance(b, Symmetry):
                pair.append({"kind": "symmetry"})
            else:
                raise TypeError(f"cannot serialize boundary condition {b!r}")
        out.append(pair)
    return out


def _bc_from_json(data):
    if data is None:
        return None
    kinds = {"periodic": lambda d: Periodic(),
             "extrapolation": lambda d: Extrapolation(d["degree"]),
             "symmetry": lambda d: Symmetry()}
    return tuple((kinds[l["kind"]](l), kinds[r["kind"]](r)) for l, r in data)


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def field_from_numpy(values, grid: Grid, bcs=None, device=None, dtype=None) -> MeshField:
    """A :class:`MeshField` from a numpy array (for example the values of a
    JAX ``MeshField``): ``dtype`` defaults to the array's own, ``device`` to
    the card (the CPU only when asked for with ``device="cpu"``)."""
    t = torch.from_numpy(np.ascontiguousarray(values))
    return MeshField(t.to(device=resolve_device(device), dtype=dtype or t.dtype), grid, bcs)


def narrowband_from_numpy(values, mask, grid: Grid, bcs, nlayers: int,
                          device=None) -> NarrowBandField:
    """A :class:`NarrowBandField` from numpy arrays (for example the
    ``values`` and ``mask`` of a JAX ``NarrowBandField``), on ``device``
    (default: the card); the compute band is recomputed from the mask."""
    device = resolve_device(device)
    v = torch.from_numpy(np.ascontiguousarray(values)).to(device)
    m = torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(device)
    return NarrowBandField(v, grid, bcs, m, int(nlayers))


def save_checkpoint(path, phi: MeshField, t: float = 0.0,
                    extra_arrays: Optional[Dict[str, Any]] = None,
                    metadata: Optional[Dict[str, Any]] = None) -> Path:
    """Write the resumable state of a dense or narrow-band field to ``path``
    (``.npz``).
    ``extra_arrays`` may carry coefficient fields, ``metadata`` any
    JSON-serializable run info."""
    path = Path(path)
    manifest = {
        "format": _FORMAT_VERSION,
        "t": float(t),
        "grid": {"lo": phi.grid.lo, "hi": phi.grid.hi, "shape": phi.grid.shape},
        "bcs": _bc_to_json(phi.bcs),
        "kind": "narrowband" if isinstance(phi, NarrowBandField) else "dense",
        "nlayers": getattr(phi, "nlayers", None),
        "metadata": metadata or {},
    }
    arrays = {"values": _to_numpy(phi.values)}
    if isinstance(phi, NarrowBandField):
        arrays["mask"] = _to_numpy(phi.mask)
    for name, arr in (extra_arrays or {}).items():
        arrays[f"extra.{name}"] = _to_numpy(arr)
    np.savez_compressed(path, manifest=json.dumps(manifest), **arrays)
    return path


def load_checkpoint(path, device=None) -> Tuple[MeshField, float, Dict[str, np.ndarray], Dict]:
    """Load ``(phi, t, extra_arrays, metadata)`` saved by either package's
    ``save_checkpoint``; the field's values go to ``device`` (default: the
    card)."""
    with np.load(Path(path), allow_pickle=False) as data:
        manifest = json.loads(str(data["manifest"]))
        if manifest["format"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint format {manifest['format']}")
        g = manifest["grid"]
        grid = Grid(g["lo"], g["hi"], g["shape"])
        bcs = _bc_from_json(manifest["bcs"])
        if manifest["kind"] == "narrowband":
            phi = narrowband_from_numpy(data["values"], data["mask"], grid, bcs,
                                        manifest["nlayers"], device=device)
        else:
            phi = field_from_numpy(data["values"], grid, bcs, device=device)
        extra = {k[len("extra."):]: np.asarray(v) for k, v in data.items()
                 if k.startswith("extra.")}
    return phi, manifest["t"], extra, manifest["metadata"]
