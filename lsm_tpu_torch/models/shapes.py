"""Signed-distance shapes and velocity fields (port of
:mod:`lsm_tpu.models.shapes`). Each shape returns a function of the
broadcastable node-coordinate tensors, suitable for
:func:`lsm_tpu_torch.core.field.sample`; each velocity a function ``u(xs,
t)`` of the coordinate tensors and time."""

from __future__ import annotations

import math

import torch

__all__ = ["circle", "sphere", "box", "plane", "torus", "star", "zalesak_disk",
           "zalesak_sphere", "dumbbell", "vortex_velocity", "rigid_rotation_velocity"]


def circle(center=(0.0, 0.0), radius=0.5):
    """Exact SDF of a circle (2D), or of a sphere given 3 coordinates."""

    def f(*xs):
        sq = sum((x - c) ** 2 for x, c in zip(xs, center))
        return torch.sqrt(sq) - radius

    return f


sphere = circle


def plane(normal, offset=0.0):
    """Half-space ``{n . x <= offset}``: SDF ``(n . x - offset) / |n|``."""
    nrm = math.sqrt(sum(c * c for c in normal))

    def f(*xs):
        return (sum(n * x for n, x in zip(normal, xs)) - offset) / nrm

    return f


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


def star(center=(0.0, 0.0), radius=0.5, amplitude=0.1, lobes=5, phase=-math.pi / 2):
    """Star-shaped curve ``r(theta) = radius + amplitude cos(lobes * theta)``
    (2D)."""

    def f(x, y):
        dx, dy = x - center[0], y - center[1]
        r = torch.sqrt(dx * dx + dy * dy)
        theta = torch.atan2(dy, dx) + phase
        return r - (radius + amplitude * torch.cos(lobes * theta))

    return f


def zalesak_disk(center=(0.5, 0.75), radius=0.15, slot_width=0.05, slot_depth=0.25):
    """Zalesak's slotted disk: a disc minus a vertical slot opening downward
    (CSG ``max(circle, -slot)``), the slot reaching from below the disc up
    to ``center_y - radius + slot_depth``."""
    cx, cy = center
    slot = box(
        (cx - slot_width / 2.0, cy - radius - slot_depth),
        (cx + slot_width / 2.0, cy - radius + slot_depth),
    )
    disc = circle(center, radius)

    def f(x, y):
        return torch.maximum(disc(x, y), -slot(x, y))

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


def dumbbell(c1=(-0.4, 0.0), c2=(0.4, 0.0), radius=0.3, bar_halfwidth=0.08):
    """Two discs joined by a bar (2D)."""
    b1 = circle(c1, radius)
    b2 = circle(c2, radius)
    bar = box((c1[0], -bar_halfwidth), (c2[0], bar_halfwidth))

    def f(x, y):
        return torch.minimum(torch.minimum(b1(x, y), b2(x, y)), bar(x, y))

    return f


def vortex_velocity(period=None):
    """Single-vortex (swirl) field on [0,1]^2 that stretches an interface
    into a spiral; with ``period`` the flow reverses as ``cos(pi t /
    period)``, so the exact solution returns to the initial one at ``t =
    period``."""

    def u(xs, t):
        x, y = xs[0], xs[1]
        sx = torch.sin(math.pi * x)
        sy = torch.sin(math.pi * y)
        ux = -(sx ** 2) * torch.sin(2.0 * math.pi * y)
        uy = torch.sin(2.0 * math.pi * x) * sy ** 2
        if period is not None:
            arg = math.pi * t / period
            mod = math.cos(arg) if isinstance(arg, (int, float)) else torch.cos(arg)
            ux, uy = ux * mod, uy * mod
        return (ux + 0.0 * y, uy + 0.0 * x)

    return u


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
