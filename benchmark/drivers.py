"""The general generator: one driver per kind of traffic, named by the
traffic file's ``driver`` key. A driver builds the program's objects from
the cell's inputs, warms the cell's own shapes, measures one window of
``seconds``, and after the window (its peak memory read, the program's
state freed) judges what the timed path produced against the reference.

- ``integrate``: ``LevelSetEquation.integrate(tf, max_steps=chunk)`` called
  again until the window has run ``seconds``, the adaptive CFL step kept.
  The set-up's warm-up call, from the seed's own field, is judged from that
  field; after the window, one more call of the same entry on the same
  object (``judge_steps`` steps, the chunk by default) is judged from the
  state it was handed (the program's own), since a 512^3 reference cannot
  follow a whole window.
- ``rollout_grad``: ``torch.autograd.grad`` of ``sum(phi(T)^2)`` through
  ``rollout(RK3(), terms, phi0, 0, dt, nsteps, remat=True)`` w.r.t. ``phi0``
  and the differentiated streamed coefficients, called again on the seed's
  inputs; every call's loss and the last call's gradients are judged.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch

from . import inputs
from . import reference as ref
from . import work


@dataclass
class Outcome:
    """What a driver hands back: the work done in the window, its wall
    time, the peak memory, the numbers compared, and the least time one
    H100 needs for a unit of the work."""
    unit: str
    units: int
    calls: int
    window_s: float
    setup_s: float
    peak_bytes: int
    least_s_per_unit: float
    checks: Dict[str, float] = field(default_factory=dict)
    judge_s: float = 0.0
    #: with ``ctx.keep``: what the judgement used (inputs, step, the
    #: reference's answers), for reading a control on the same inputs
    evidence: dict = field(default_factory=dict)


# blocks a side of the gradients' block means
BLOCKS = 32


def rel_max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """``max|a - b| / max|b|``, in float64."""
    b64 = b.double()
    return float((a.double() - b64).abs().max() / b64.abs().max())


def process_age() -> float:
    """Seconds since this process started (``/proc``, 10 ms resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _program_terms(lsm, terms_cfg, coefs, grid, bcs):
    out = []
    for t, c in zip(terms_cfg, coefs):
        if inputs.is_streamed(c):
            c = lsm.MeshField(c, grid, bcs)
        if t["kind"] == "advection":
            out.append(lsm.AdvectionTerm(c))
        elif t["kind"] == "normal":
            out.append(lsm.NormalMotionTerm(c))
        elif t["kind"] == "curvature":
            out.append(lsm.CurvatureTerm(c))
        else:
            raise ValueError(f"unknown term kind {t['kind']!r}")
    return tuple(out)


def _program_grid(lsm, cfg, shape):
    grid = lsm.Grid(cfg["grid"]["lo"], cfg["grid"]["hi"], shape)
    kind, degree = inputs.bc_of(cfg)
    bc = lsm.Periodic() if kind == "periodic" else lsm.Extrapolation(degree)
    return grid, bc


def _window(seconds: float, device, tracer, call: Callable[[], int]):
    """Run ``call`` (it returns the units it did) until ``seconds`` have
    passed, then wait for the card: ``(calls, units, wall seconds)``."""
    calls = units = 0
    with tracer.profiling():
        t0 = time.perf_counter()
        while True:
            with tracer.span("bench.call"):
                units += call()
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        wall = time.perf_counter() - t0
    return calls, units, wall


def integrate(ctx) -> Outcome:
    import lsm_tpu_torch as lsm

    ctx.marks["program imported"] = process_age()
    cfg, traffic, device = ctx.cfg, ctx.traffic, ctx.device
    shape = inputs.grid_shape(cfg, ctx.n_override)
    terms_cfg = inputs.terms_of(cfg, "forward")
    coefs = [inputs.coefficient(t, cfg, shape, device) for t in terms_cfg]
    phi0 = inputs.initial_field(cfg, traffic, ctx.seed, device, ctx.n_override)
    ctx.marks["inputs made"] = process_age()
    grid, bc = _program_grid(lsm, cfg, shape)
    eq = lsm.LevelSetEquation(terms=_program_terms(lsm, terms_cfg, coefs, grid, bc),
                              ic=lsm.MeshField(phi0, grid, bc),
                              integrator=lsm.RK3(cfl=inputs.rk3_cfl(cfg)))
    tf, chunk = float(traffic["tf"]), int(traffic["chunk_steps"])
    eq.integrate(tf, max_steps=int(traffic["warmup_steps"]))
    # the start's evidence waits in host memory, so that the window's peak
    # is the program's alone
    start = (phi0.cpu(), eq.state.values.cpu(), eq.t, eq.last_nsteps, eq.last_fast_path)
    del phi0

    def call(max_steps=chunk):
        eq.integrate(tf, max_steps=max_steps)
        if eq.last_fast_path != "fused":
            raise RuntimeError(f"integrate took the {eq.last_fast_path!r} path, not the fused one")
        return eq.last_nsteps

    setup_s = process_age()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    calls, steps, wall = _window(ctx.seconds, device, ctx.tracer, call)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    judged = int(traffic.get("judge_steps", chunk))
    last = {"input": eq.state.values, "t": eq.t}
    call(judged)
    last.update(output=eq.state.values, dt=eq.t - last["t"], steps=eq.last_nsteps)
    del eq, call
    if start[4] != "fused":
        raise RuntimeError(f"the warm-up took the {start[4]!r} path, not the fused one")

    t_judge = time.perf_counter()
    prob = inputs.problem(cfg, terms_cfg, coefs, device, ctx.n_override, ctx.reference_dtype)
    checks, evidence = {}, {"prob": prob, "tf": tf}
    for tag, (x0, x1, t0, dt, steps_done) in (
            ("start", (start[0], start[1], 0.0, start[2], start[3])),
            ("last", (last["input"], last["output"], last["t"], last["dt"], last["steps"]))):
        max_steps = int(traffic["warmup_steps"]) if tag == "start" else judged
        x0, x1 = x0.to(device), x1.to(device)
        want, t_ref, n_ref = ref.integrate(x0, t0, tf, max_steps, prob)
        checks.update(forward_gaps(tag, x1, dt, steps_done, want, t_ref - t0, n_ref))
        if ctx.keep:
            evidence[tag] = (x0, t0, max_steps, want, t_ref - t0, n_ref, x1)
        del want
    ops, nbytes = work.forward_step(terms_cfg, cfg["dtype"])
    least = work.least_seconds(ops, nbytes, work.nodes_of(shape), cfg["dtype"])
    return Outcome("step", steps, calls, wall, setup_s, peak, least, checks,
                   time.perf_counter() - t_judge, evidence)


def forward_gaps(tag, state, dt, steps, want, dt_ref, steps_ref):
    """The numbers a forward call is judged by: the state's largest gap
    (relative to the reference's largest value), the gap of the time it
    advanced (relative), and of its step count."""
    return {f"state_gap_{tag}": rel_max_gap(state, want),
            f"dt_gap_{tag}": abs(dt - dt_ref) / dt_ref,
            f"steps_gap_{tag}": float(abs(steps - steps_ref))}


def rollout_grad(ctx) -> Outcome:
    import lsm_tpu_torch as lsm

    ctx.marks["program imported"] = process_age()
    cfg, traffic, device = ctx.cfg, ctx.traffic, ctx.device
    shape = inputs.grid_shape(cfg, ctx.n_override)
    gcfg = cfg["gradient"]
    terms_cfg = inputs.terms_of(cfg, "gradient")
    coefs = [inputs.coefficient(t, cfg, shape, device) for t in terms_cfg]
    phi0 = inputs.initial_field(cfg, traffic, ctx.seed, device, ctx.n_override)
    ctx.marks["inputs made"] = process_age()
    streams = [c if inputs.is_streamed(c) else None for c in coefs]
    dt = inputs.gradient_dt(cfg, inputs.problem(cfg, terms_cfg, coefs, device, ctx.n_override),
                            streams)
    nsteps = int(gcfg["nsteps"])
    grid, bc = _program_grid(lsm, cfg, shape)
    v = phi0.detach().requires_grad_()
    leaves = [c.detach().requires_grad_() if inputs.is_streamed(c) else c for c in coefs]
    wrt = [v] + [c for c in leaves if inputs.is_streamed(c)]
    integrator = lsm.RK3(cfl=inputs.rk3_cfl(cfg))
    losses: List[torch.Tensor] = []
    grads = {}

    def call():
        terms = _program_terms(lsm, terms_cfg, leaves, grid, bc)
        out, _ = lsm.rollout(integrator, terms, lsm.MeshField(v, grid, bc), 0.0, dt, nsteps,
                             remat=bool(traffic["remat"]))
        loss = (out.values ** 2).sum()
        grads["last"] = torch.autograd.grad(loss, wrt, allow_unused=True)
        losses.append(loss.detach())
        return 1

    call()
    _sync(device)
    losses.clear()
    setup_s = process_age()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    calls, units, wall = _window(ctx.seconds, device, ctx.tracer, call)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    got = [torch.zeros_like(x) if g is None else g for g, x in zip(grads.pop("last"), wrt)]
    del call, v, leaves, wrt
    t_judge = time.perf_counter()
    prob = inputs.problem(cfg, terms_cfg, coefs, device, ctx.n_override, ctx.reference_dtype)
    want = ref.rollout_grad(phi0, dt, nsteps, prob, streams)
    names = [t["kind"] for t, s in zip(terms_cfg, streams) if s is not None]
    checks = gradient_gaps([float(x) for x in losses], got, want, names)
    evidence = {"prob": prob, "phi0": phi0, "streams": streams, "dt": dt, "nsteps": nsteps,
                "want": want, "names": names, "got": got} if ctx.keep else {}
    del want
    ops, nbytes = work.gradient_call(terms_cfg, cfg["dtype"], nsteps, len(got) - 1)
    least = work.least_seconds(ops, nbytes, work.nodes_of(shape), cfg["dtype"])
    return Outcome("call", units, calls, wall, setup_s, peak, least, checks,
                   time.perf_counter() - t_judge, evidence)


def block_means(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over blocks of ``max(1, n // 32)`` nodes a side (the
    last block of an axis over what is left), in float64."""
    b = max(1, min(x.shape) // BLOCKS)
    return torch.nn.functional.avg_pool3d(x.double()[None, None], b, ceil_mode=True)[0, 0]


def gradient_gaps(losses, grads, want, names):
    """The numbers a gradient call is judged by: the largest relative gap
    of any call's loss, and for each gradient the largest gap of its block
    means relative to the reference's largest block mean. Node by node, a
    float32 gradient through many WENO5 steps carries rounding that its
    nonlinear weights amplify (a plain float32 reference reads the same);
    the block means keep what a wrong adjoint changes."""
    loss_ref, g_ref, gs_ref = want
    out = {"loss_gap": max(abs(x - loss_ref) for x in losses) / abs(loss_ref)}
    for name, mine, g in zip(["phi0"] + list(names), grads,
                             [g_ref] + [g for g in gs_ref if g is not None]):
        out[f"grad_block_gap_{name}"] = rel_max_gap(block_means(mine), block_means(g))
    return out


DRIVERS = {"integrate": integrate, "rollout_grad": rollout_grad}
