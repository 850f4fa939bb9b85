"""What a cell's inputs are, made from its configuration and ``--seed``,
and the reference's view of the same configuration.

Nothing here imports the program: the field, the coefficients and the step
that both sides are handed are the benchmark's own. A configuration file
(``configs/<name>.json``) names the grid, the boundary condition, the shape
whose signed distance is the initial level set, the terms and the
integrator; its ``gradient`` group the term list, step count, step and
loss of the gradient cells. A traffic file names how the seed moves the
shape (``center_jitter_cells``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from . import reference as ref

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def grid_shape(cfg, n_override=None):
    n = cfg["grid"]["n"]
    return tuple(int(n_override) for _ in n) if n_override else tuple(int(v) for v in n)


def spacing(cfg, shape):
    lo, hi = cfg["grid"]["lo"], cfg["grid"]["hi"]
    return tuple((float(b) - float(a)) / (m - 1) for a, b, m in zip(lo, hi, shape))


def bc_of(cfg):
    bc = cfg["bc"]
    return (bc["kind"], int(bc.get("degree", 0)))


# -- shapes: signed distances of the initial level set ----------------------------------


def _box(xs, lo, hi):
    q = [torch.abs(x - (a + b) / 2.0) - (b - a) / 2.0 for x, a, b in zip(xs, lo, hi)]
    outside = sum(torch.clamp(qi, min=0.0) ** 2 for qi in q)
    inside = torch.maximum(torch.maximum(q[0], q[1]), q[2])
    return torch.sqrt(outside) + torch.clamp(inside, max=0.0)


def zalesak_sphere(xs, center, radius, slot_width, slot_depth):
    """A ball minus a slot box, ``max(ball, -slot)``: the slot is
    ``slot_width`` wide along axis 0, runs through the ball along axis 2,
    and reaches from below the ball up to ``center_y - radius + slot_depth``."""
    cx, cy, cz = center
    ball = torch.sqrt(sum((x - c) ** 2 for x, c in zip(xs, center))) - radius
    slot = _box(xs, (cx - slot_width / 2.0, cy - radius - slot_depth, cz - radius - slot_depth),
                (cx + slot_width / 2.0, cy - radius + slot_depth, cz + radius + slot_depth))
    return torch.maximum(ball, -slot)


def torus(xs, center, major, minor):
    """The torus around axis 2 through ``center``."""
    q = torch.sqrt((xs[0] - center[0]) ** 2 + (xs[1] - center[1]) ** 2) - major
    return torch.sqrt(q ** 2 + (xs[2] - center[2]) ** 2) - minor


SHAPES = {"zalesak_sphere": zalesak_sphere, "torus": torus}


def center_offset(seed: int, jitter_cells: float, h: Sequence[float]):
    """The seed's move of the shape's centre: uniform in
    ``[-jitter/2, jitter/2)`` cells on each axis (under one cell in all)."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    u = torch.rand(3, generator=gen, dtype=torch.float64) - 0.5
    return tuple(float(x) * jitter_cells * hd for x, hd in zip(u, h))


def initial_field(cfg, traffic, seed: int, device, n_override=None) -> torch.Tensor:
    """The seed's initial level set at the nodes ``lo + i*h``, computed on
    ``device`` in float64 and stored in the configuration's dtype."""
    shape = grid_shape(cfg, n_override)
    h = spacing(cfg, shape)
    s = dict(cfg["shape"])
    kind = s.pop("kind")
    off = center_offset(seed, float(traffic.get("center_jitter_cells", 0.0)), h)
    s["center"] = tuple(float(c) + o for c, o in zip(s["center"], off))
    xs = []
    for d, n in enumerate(shape):
        view = [1, 1, 1]
        view[d] = n
        i = torch.arange(n, dtype=torch.float64, device=device).reshape(view)
        xs.append(float(cfg["grid"]["lo"][d]) + i * h[d])
    phi = SHAPES[kind](xs, **s)
    return phi.to(DTYPES[cfg["dtype"]]).contiguous()


# -- coefficients ------------------------------------------------------------------------


def rigid_rotation(center, omega):
    """``u = omega * (-(y - cy), x - cx, 0)`` as a callable ``f(xs, t)``
    of plain arithmetic on the coordinates, which the program traces into an
    in-kernel program and the reference evaluates on tensors."""
    cx, cy = float(center[0]), float(center[1])
    omega = float(omega)

    def velocity(xs, t):
        zero = 0.0 * (xs[0] + xs[1] + xs[2])
        return (-omega * (xs[1] - cy) + zero, omega * (xs[0] - cx) + zero, zero)

    return velocity


def linear_field(spec, cfg, shape, device, dtype):
    """``c0 + grad . x`` at the nodes ``lo + i*h``, in ``dtype``."""
    h = spacing(cfg, shape)
    out = torch.full(shape, float(spec["c0"]), dtype=torch.float64, device=device)
    for d, g in enumerate(spec["grad"]):
        if g:
            view = [1, 1, 1]
            view[d] = shape[d]
            i = torch.arange(shape[d], dtype=torch.float64, device=device).reshape(view)
            out = out + float(g) * (float(cfg["grid"]["lo"][d]) + i * h[d])
    return out.to(dtype).contiguous()


def coefficient(term_cfg, cfg, shape, device):
    """A term's coefficient as the cell hands it to both sides: a callable
    (``rigid_rotation``), a number, or a streamed tensor (``linear_field``)
    in the configuration's dtype."""
    kind = term_cfg["kind"]
    c = term_cfg["velocity" if kind == "advection" else "coef"]
    if isinstance(c, (int, float)):
        return float(c)
    if c["kind"] == "rigid_rotation":
        return rigid_rotation(c["center"], c["omega"])
    if c["kind"] == "linear_field":
        return linear_field(c, cfg, shape, device, DTYPES[cfg["dtype"]])
    raise ValueError(f"unknown coefficient kind {c['kind']!r}")


def terms_of(cfg, group: str) -> Sequence[Dict]:
    """The term list of the forward cells (``group == "forward"``) or of the
    gradient cells."""
    return cfg["terms"] if group == "forward" else cfg["gradient"].get("terms", cfg["terms"])


def rk3_cfl(cfg) -> float:
    """The CFL number of the configuration's integrator, which both sides
    run as TVD RK3: any other kind is refused, since neither the drivers nor
    the reference run it."""
    integ = cfg["integrator"]
    if integ["kind"] != "RK3":
        raise ValueError(f"the benchmark runs RK3 only, not {integ['kind']!r}")
    return float(integ["cfl"])


def problem(cfg, terms_cfg, coefs, device, n_override=None, dtype=torch.float64):
    """The reference's view of the configuration with the coefficients
    ``coefs`` (one per term, as :func:`coefficient` made them), computed in
    ``dtype``."""
    shape = grid_shape(cfg, n_override)
    terms = [ref.Term(t["kind"], c) for t, c in zip(terms_cfg, coefs)]
    return ref.Problem(shape, tuple(float(v) for v in cfg["grid"]["lo"]), spacing(cfg, shape),
                       bc_of(cfg), terms, rk3_cfl(cfg), dtype, DTYPES[cfg["dtype"]], device)


def gradient_dt(cfg, prob: ref.Problem, streams) -> float:
    """The gradient cells' fixed step: a fraction of the spacing, or of the
    term list's CFL bound at the initial state."""
    rule = cfg["gradient"]["dt"]
    if "spacing_fraction" in rule:
        return float(rule["spacing_fraction"]) * min(prob.spacing)
    if "cfl_fraction" in rule:
        return float(rule["cfl_fraction"]) * ref.cfl_bound(prob, 0.0, streams)
    raise ValueError(f"unknown step rule {rule!r}")


def is_streamed(c) -> bool:
    return isinstance(c, torch.Tensor)
