"""Signed-distance shapes and velocity fields (port of part of
:mod:`lsm_tpu.models.shapes`). Each shape returns a function of the
broadcastable node-coordinate tensors, suitable for
:func:`lsm_tpu_torch.core.field.sample`."""

from __future__ import annotations

import torch

__all__ = ["circle", "sphere", "box", "zalesak_sphere", "torus", "rigid_rotation_velocity"]


def circle(center=(0.0, 0.0), radius=0.5):
    """Exact SDF of a circle (2D), or of a sphere given 3 coordinates."""

    def f(*xs):
        sq = sum((x - c) ** 2 for x, c in zip(xs, center))
        return torch.sqrt(sq) - radius

    return f


sphere = circle


def box(lo, hi):
    """Exact SDF of an axis-aligned box ``[lo, hi]``."""

    def f(*xs):
        center = [(l + h) / 2.0 for l, h in zip(lo, hi)]
        half = [(h - l) / 2.0 for l, h in zip(lo, hi)]
        q = [torch.abs(x - c) - s for x, c, s in zip(xs, center, half)]
        outside_sq = sum(torch.clamp(qi, min=0.0) ** 2 for qi in q)
        inside = q[0]
        for qi in q[1:]:
            inside = torch.maximum(inside, qi)
        return torch.sqrt(outside_sq) + torch.clamp(inside, max=0.0)

    return f


def zalesak_sphere(center=(0.5, 0.75, 0.5), radius=0.15, slot_width=0.05, slot_depth=0.25):
    """3D slotted sphere: ball minus a slot box (CSG ``max(ball, -slot)``)."""
    cx, cy, cz = center
    slot = box(
        (cx - slot_width / 2.0, cy - radius - slot_depth, cz - radius - slot_depth),
        (cx + slot_width / 2.0, cy - radius + slot_depth, cz + radius + slot_depth),
    )
    ball = sphere(center, radius)

    def f(x, y, z):
        return torch.maximum(ball(x, y, z), -slot(x, y, z))

    return f


def torus(center=(0.0, 0.0, 0.0), major=0.5, minor=0.2):
    """Exact SDF of a torus around the z-axis through ``center`` (3D)."""

    def f(x, y, z):
        qx = torch.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2) - major
        return torch.sqrt(qx ** 2 + (z - center[2]) ** 2) - minor

    return f


def rigid_rotation_velocity(center=(0.0, 0.0), omega=1.0):
    """Rigid-body rotation about the third axis through ``center``:
    ``u = omega * (-(y - cy), x - cx)``, plus a zero component per further
    coordinate (so a 3D field gets ``(u, v, 0)``)."""

    def u(xs, t):
        x, y = xs[0], xs[1]
        zero = 0.0 * sum(xs)
        comps = (-omega * (y - center[1]) + zero, omega * (x - center[0]) + zero)
        return comps + tuple(zero for _ in xs[2:])

    return u
