"""The kernel wrappers' launch counters.

Each wrapper carries plain integer attributes (``launches`` and, for some,
``kinds_launches`` and ``program_launches``) that a run reads to show which
kernels it went through. The shards of an in-process mesh
(:mod:`lsm_tpu_torch.parallel.spmd`) launch from several threads, and ``+=``
on an attribute is a read-modify-write, so every increment goes through
:func:`bump`, under one lock.
"""

from __future__ import annotations

import threading

__all__ = ["bump"]

_LOCK = threading.Lock()


def bump(fn, **counts) -> None:
    """Add each ``name=n`` of ``counts`` to the attribute ``name`` of ``fn``."""
    with _LOCK:
        for name, n in counts.items():
            setattr(fn, name, getattr(fn, name) + int(n))
