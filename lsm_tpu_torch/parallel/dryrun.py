"""A small end-to-end run of every sharded path (the counterpart of the JAX
package's ``dryrun_multichip``): one differentiable training step through
the sharded fused rollout, then the sharded dense, band and fused
evolutions, each for a few steps on small shapes.

Run it on the card (``python3 -c "from lsm_tpu_torch.parallel.dryrun import
dryrun_multichip; print(dryrun_multichip(4))"``) or on the CPU with
``devices=["cpu"] * n``.
"""

from __future__ import annotations

import torch

from .. import (AdvectionTerm, Extrapolation, Grid, NarrowBandField, Periodic, RK3, sample,
                volume)
from ..models import shapes
from .evolve import make_sharded_evolve
from .fused_evolve import make_sharded_fused_rollout
from .sharding import make_mesh, shard_field, unshard

__all__ = ["dryrun_multichip"]


def _rotation(xs, t):
    zero = 0.0 * (xs[0] + xs[1] + xs[2])
    return (0.5 - xs[1] + zero, xs[0] - 0.5 + zero, zero)


STEPS = 3  # each sharded evolution's steps


def dryrun_multichip(n: int, devices=None) -> dict:
    """Every sharded path on ``n`` shards: ``devices`` (default: the CUDA
    devices, repeated in turn until there are ``n``; none raises) may
    repeat a device. Returns what each path gave (the training step's loss
    and gradient norms, each evolution's steps and time reached); raises
    ``ArithmeticError`` on a non-finite result."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass devices=["cpu"] * n to run on the CPU')
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [cards[i % len(cards)] for i in range(n)]
    mesh = make_mesh(n_devices=n, devices=devices)
    dev = mesh.devices.flat[0]
    out = {"mesh": dict(mesh.shape)}
    grid = Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (32, 32, 16))
    phi = sample(shapes.sphere((0.5, 0.5, 0.5), 0.3), grid, Periodic(), dtype=torch.float32,
                 device=dev)
    vel = sample(lambda x, y, z: _rotation((x, y, z), 0.0), grid, vector=True,
                 dtype=torch.float32, device=dev)
    dt = 0.5 * grid.min_spacing

    # a training step: loss through the sharded fused rollout, gradients for
    # the initial level set and the streamed velocity, one descent update
    rollout = make_sharded_fused_rollout(RK3(), mesh, grid, nsteps=2)
    v = phi.values.clone().requires_grad_()
    u = vel.values.clone().requires_grad_()
    final = rollout((AdvectionTerm(vel.with_values(u)),), phi.with_values(v), 0.0, dt)
    loss = (volume(final) - 0.1) ** 2
    g_phi, g_vel = torch.autograd.grad(loss, (v, u))
    with torch.no_grad():
        new_phi, new_vel = v - 0.1 * g_phi, u - 0.1 * g_vel
    out["train_step"] = {"loss": float(loss.detach()), "grad_phi_norm": float(g_phi.norm()),
                         "grad_vel_norm": float(g_vel.norm())}
    if not all(bool(torch.isfinite(x).all()) for x in (loss, new_phi, new_vel)):
        raise ArithmeticError("non-finite sharded training step")

    # the sharded evolutions: dense and band on the general path, dense fused
    sphi, term = shard_field(phi, mesh), AdvectionTerm(shard_field(vel, mesh))
    runs = {"dense": make_sharded_evolve(RK3(), mesh, grid, max_steps=STEPS),
            "band": make_sharded_evolve(RK3(), mesh, grid, max_steps=STEPS, is_band=True)}
    band = NarrowBandField.from_field(sample(shapes.sphere((0.5, 0.5, 0.5), 0.3), grid,
                                             Extrapolation(2), dtype=torch.float32,
                                             device=dev))
    for name, ev in runs.items():
        res, t, k = ev((term,), sphi if name == "dense" else band, 0.0, 1.0)
        vals = (unshard(res) if name == "dense" else res).values
        out[name] = {"steps": k, "t": t}
        if k != STEPS or not bool(torch.isfinite(vals).all()):
            raise ArithmeticError(f"sharded {name} evolve: {k} steps, finite "
                                  f"{bool(torch.isfinite(vals).all())}")
    grid_f = Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (32, 32, 32))
    phi_f = sample(shapes.sphere((0.5, 0.5, 0.5), 0.3), grid_f, Periodic(),
                   dtype=torch.float32, device=dev)
    ev = make_sharded_evolve(RK3(), mesh, grid_f, max_steps=STEPS, fused=True)
    res, t, k = ev((AdvectionTerm(_rotation),), phi_f, 0.0, 1.0)
    out["fused"] = {"steps": k, "t": t}
    if k != STEPS or not bool(torch.isfinite(res.values).all()):
        raise ArithmeticError("non-finite sharded fused evolve")
    return out
