"""Where the port's entry points put tensors when the caller names no device.

The port runs on the card: with no ``device`` given, the entry points
(``sample``, ``Grid.coords``/``axis_coords``, ``field_from_numpy``,
``load_checkpoint``) place their tensors on ``cuda``. The CPU runs only when
it is asked for (``device="cpu"``); a machine without a card raises rather
than quietly running plain torch on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "dtype_str"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card (``cuda``).
    Raises ``RuntimeError`` when ``device`` is ``None`` and there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: lsm_tpu_torch places tensors on the card by default; "
            'pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def dtype_str(dtype: torch.dtype) -> str:
    """A dtype as the display trees print it, JAX's way: ``float32``, not
    ``torch.float32``."""
    return str(dtype).removeprefix("torch.")
