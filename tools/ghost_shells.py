"""Time the ghost-shell kernels of this tree on an H100, each in this process of
its own (the profiler under-reads device time late in a long process):
K2's 3D refresh and the fold of a stage output's cotangent (K4) at 512^3 f32
beside ``g.clone()``, K5 (the shell zeroing) at 512^3 and 4096^2, K2's
single-axis phases at the sharded flagship's shard shapes; optionally K2,
K4 and K7 on the route for an ``Extrapolation`` of degree above 7, and the
cells that run them.

Run from the root of a tree of this repository (its own ``chip_smoke``
helpers and package):

    python3 tools/ghost_shells.py [label] [--parts k2k4,k5,axis,degree,flagship,cells]
                                  [--save PATH]

Parts (default ``k2k4,k5,axis``, what ``chip_smoke.py``'s timing reads):

- ``k2k4``: three states: the flagship's (the 512^3 Zalesak sphere,
  Periodic), config A's (the torus, ``Extrapolation(2)``) and the sphere under
  mixed BCs with ``Extrapolation(7)``. The calls: K2 on the packed state;
  "fold" as the backward runs it (a tree whose K4 folds in place: ``clone``
  and then K4; one whose K4 writes a new buffer: K4 alone); K4 alone;
  ``g.clone()``; and K4's 2D entry at 4096^2 (Periodic, ``Extrapolation(2)``).
- ``k5``: K5 on a random cotangent's buffer at 512^3 (``K5``) and at 4096^2
  (``K5_2d``), as the stage backward zeroes ``daux``'s shells.
- ``axis``: K2's single-axis phase on ``chip_smoke.K9_SETS`` buffers in turn
  (out of the 50 MB L2, as in a stage), Periodic: axis 2 at the (2, 2)
  mesh's shard 256x256x512, axes 1 and 2 at the (4, 1) mesh's 128x512x512.
- ``degree``: the route for an ``Extrapolation`` of degree above 7 (the
  table route) at 512^3 f32: K2, K4 and K7 (flags on and off) under
  ``Extrapolation(8)`` beside the by-value route's ``Extrapolation(7)``, on
  the same interior and cotangent; ``g.clone()`` of that cotangent (K4's copy
  floor). ``--save`` adds the SHA-256 of the table route's outputs: K2 (3D,
  each axis, 2D), K4 (3D, 2D) and K7 (3D, 2D, each gate) under
  ``chip_smoke.degree_cases`` and ``Extrapolation(19)``, f32 and f64, on
  scribbled buffers.
- ``flagship``: the 512^3 Zalesak RK3 ``integrate`` with the rotation
  in-kernel, under ``Periodic`` and under ``Extrapolation(8)``: ms a step
  (CUDA-event median of 5 calls of 10 steps, each from the initial state,
  as ``chip_smoke.py``'s k2_degree times it: a degree-8 extrapolation does
  not stay finite over hundreds of steps of the rotation), and one profile
  of 3 steps each: wall, device busy, and the device time by kind of kernel
  (K1'' the stage, K2 the refresh, the program tables, the rest: the CFL
  bound's torch kernels, pack and unpack).
- ``cells``: ms (CUDA-event median) and peak GiB of cell (b) per RK3 step,
  the kinds gradient (grad_kinds) and the 2D gradients (grad2d,
  grad2d_kinds) per ``value_and_grad``, and the sharded 512^3 RK3 flagship
  per step on the (4, 1) and (2, 2) meshes of the card.

Each kernel call gets three readings: the CUDA-event median
(``chip_smoke.cuda_time``), the time a call of 50 issued back to back
(``back_to_back_ms``) and the profiler's device time a call
(``device_ms``); K2, K4 and the clone also the device time of each launch by
kernel name. Prints one line, ``SHELLS <label> key value ...``. ``--save
PATH`` writes the SHA-256 of the outputs of K5 (scribbled 512^3 and 4096^2
buffers) and of K2's single-axis phases (every axis at both shard shapes,
f32 and f64, Periodic and mixed BCs) to PATH as JSON, for comparing trees.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import re
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import lsm_tpu_torch as lsm  # noqa: E402
from lsm_tpu_torch import parallel as par  # noqa: E402
from lsm_tpu_torch.ops import band as bd  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402
from lsm_tpu_torch.ops import weno_v2_bwd as bwd  # noqa: E402

MIXED7 = [(lsm.Extrapolation(7), lsm.Symmetry()), lsm.Periodic(),
          (lsm.Symmetry(), lsm.Extrapolation(5))]


def launches_ms(fn, reps=20):
    """``[(kernel name, device ms)]`` of each launch of one call of ``fn``,
    in issue order, averaged over ``reps`` calls (warmed up first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    per = len(kern) // reps
    return [(kern[i].name, sum(e.time_range.elapsed_us() for e in kern[i::per]) / 1e3 / reps)
            for i in range(per)]


def folds_in_place(dev) -> bool:
    """Whether this tree's K4 folds its argument in place (and returns it)."""
    g = torch.zeros(v2.padded_shape((8, 8, 8)), device=dev)
    return bwd.fold_ghost_cotangent_fast(g, cs.bc_cases()["periodic"], (8, 8, 8)) is g


def timed(out, key, fn, per_launch=False):
    """The three readings of ``fn`` into ``out``."""
    out[f"{key}_event"] = cs.cuda_time(fn)
    out[f"{key}_b2b"] = cs.back_to_back_ms(fn)
    out[f"{key}_device"] = cs.device_ms(fn)
    if per_launch:
        for i, (kernel, ms) in enumerate(launches_ms(fn)):
            m = re.search(r"(\w+)<", kernel)
            out[f"{key}_launch{i}[{m.group(1) if m else kernel.split()[0]}]"] = ms


def k2k4(dev, out):
    in_place = folds_in_place(dev)
    out["in_place"] = float(in_place)
    _, phi, _ = cs.zalesak(cs.N_MAIN, dev)
    torus = cs.torus_field(cs.N_MAIN, dev)
    states = {"periodic": (phi.values, phi.bcs), "extrap2": (torus.values, torus.bcs),
              "mixed7": (phi.values, lsm.normalize_bcs(MIXED7, 3))}
    del torus
    for name, (values, bcs) in states.items():
        shape = tuple(values.shape)
        P = v2.pack_padded(values, bcs)
        G = torch.randn(v2.padded_shape(shape),
                        generator=torch.Generator(device=dev).manual_seed(8), device=dev)
        clone = lambda: G.clone(memory_format=torch.contiguous_format)
        if in_place:
            fold = lambda: bwd.fold_ghost_cotangent_fast(clone(), bcs, shape)
            k4 = lambda: bwd.fold_ghost_cotangent_fast(G, bcs, shape)
        else:
            fold = k4 = lambda: bwd.fold_ghost_cotangent_fast(G, bcs, shape)
        calls = {"K2": lambda: v2.refresh_ghosts_fast(P, bcs, shape), "fold": fold, "K4": k4,
                 "clone": clone}
        for key, fn in calls.items():
            timed(out, f"{name}_{key}", fn, per_launch=True)
        del P, G, calls, fold, k4, clone, values
        torch.cuda.empty_cache()
    shape = (cs.N_2D,) * 2  # K4's 2D entry at 4096^2, as the 2D gradients run it
    for name, bc in (("periodic", lsm.Periodic()), ("extrap2", lsm.Extrapolation(2))):
        bcs = lsm.normalize_bcs(bc, 2)
        G = torch.randn(v2.padded_shape(shape),
                        generator=torch.Generator(device=dev).manual_seed(8), device=dev)
        timed(out, f"{name}_K4_2d", lambda: bwd.fold_ghost_cotangent_fast(G, bcs, shape))
        del G


def k5(dev, out, sums):
    gen = torch.Generator(device=dev).manual_seed(8)
    for key, shape in (("K5", (cs.N_MAIN,) * 3), ("K5_2d", (cs.N_2D,) * 2)):
        G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev)
        if sums is not None:
            sums[key] = sha(bwd.zero_pad_shells(G.clone(), shape))
        timed(out, key, lambda: bwd.zero_pad_shells(G, shape))
        del G
        torch.cuda.empty_cache()


def axis_phases(dev, out, sums):
    gen = torch.Generator(device=dev).manual_seed(19)
    periodic = lsm.normalize_bcs(lsm.Periodic(), 3)
    for ms, axes in (((2, 2), (2,)), ((4, 1), (1, 2))):
        shape = (cs.N_MAIN // ms[0], cs.N_MAIN // ms[1], cs.N_MAIN)
        if sums is not None:
            for dtype, (name, bcs) in itertools.product(
                    (torch.float32, torch.float64),
                    (("periodic", periodic), ("mixed7", lsm.normalize_bcs(MIXED7, 3)))):
                P = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
                for ax in range(3):
                    sums[f"K2ax_{ms[0]}x{ms[1]}_axis{ax}_{name}_{str(dtype)[6:]}"] = sha(
                        v2.refresh_axis_fast(P.clone(), bcs, shape, ax))
                del P
        bufs = [torch.zeros(v2.padded_shape(shape), device=dev) for _ in range(cs.K9_SETS)]
        for ax in axes:
            it = itertools.cycle(bufs)
            timed(out, f"K2ax_{ms[0]}x{ms[1]}_axis{ax}",
                  lambda: v2.refresh_axis_fast(next(it), periodic, shape, ax))
        del bufs
        torch.cuda.empty_cache()


def cells(dev, out):
    def cell(key, call, per=1, reps=10):
        out[f"{key}_ms"] = cs.cuda_time(call, warmup=1, reps=reps) / per
        out[f"{key}_peak_gib"] = cs.peak_gib(call)
        torch.cuda.empty_cache()

    grid, phi, _ = cs.zalesak(cs.N_MAIN, dev)
    dt = 0.25 * grid.min_spacing
    v = phi.values.clone().requires_grad_()
    cell("cellB_per_step", lambda: cs.rollout_grad(phi, v, dt, cs.ROLLOUT_STEPS, remat=True),
         per=cs.ROLLOUT_STEPS)
    del v
    term = lsm.AdvectionTerm(cs.rotation)
    for ms in cs.SHARDED_MESHES:
        mesh = cs.card_mesh(dev, ms)
        ev = par.make_sharded_evolve(lsm.RK3(), mesh, grid, fused=True,
                                     max_steps=cs.SHARDED_STEPS)
        sphi = par.shard_field(phi, mesh)
        cell(f"sharded_{ms[0]}x{ms[1]}_per_step", lambda: ev((term,), sphi, 0.0, 1.0),
             per=cs.SHARDED_STEPS)
        del ev, sphi
    del phi
    torus = cs.torus_field(cs.N_MAIN, dev)
    s = cs.c_term(torus).speed.values
    kdt = 0.5 * float(lsm.compute_cfl(cs.grad_kinds_terms(torus, s), torus, 0.0))
    cell("grad_kinds", lambda: cs.grad_kinds(torus, torus.values.clone().requires_grad_(),
                                             s.clone().requires_grad_(), kdt,
                                             cs.GRAD_KINDS_STEPS), reps=3)
    del torus, s
    for name in ("grad2d", "grad2d_kinds"):
        cphi, terms_of, cs_, cdt, nsteps = cs.grad2d_cell(name, cs.N_2D, dev)
        cell(name, lambda: cs.grad2d_value_and_grad(cphi, terms_of, cs_, cdt, nsteps,
                                                     cphi.values.clone().requires_grad_()))
        del cphi


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy()).hexdigest()


DEGREE_SUM_SHAPES = ((40, 72, 136), (67, 131))  # every axis at least 20 nodes (degree 19)


def degree_sums(dev, sums):
    """The SHA-256 of the table route's outputs into ``sums``."""
    gen = torch.Generator(device=dev).manual_seed(22)
    gates = [torch.tensor(f, dtype=torch.int32, device=dev)
             for f in itertools.product((0, 1), repeat=2)]
    for dtype, shape in itertools.product((torch.float32, torch.float64), DEGREE_SUM_SHAPES):
        cases = dict(cs.degree_cases(len(shape)),
                     extrap19=lsm.normalize_bcs(lsm.Extrapolation(19), len(shape)))
        for name, bcs in cases.items():
            key = f"{len(shape)}D_{name}_{str(dtype)[6:]}"
            vals = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            P = cs.scribbled(vals, bcs, gen)
            G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
            sums[f"K2_{key}"] = sha(v2.refresh_ghosts_fast(P.clone(), bcs, shape))
            if len(shape) == 3:
                for ax in range(3):
                    sums[f"K2ax{ax}_{key}"] = sha(v2.refresh_axis_fast(P.clone(), bcs, shape, ax))
            sums[f"K4_{key}"] = sha(bwd.fold_ghost_cotangent_fast(G, bcs, shape))
            for flags in gates:
                sums[f"K7_{''.join(map(str, flags.tolist()))}_{key}"] = sha(
                    bd.refresh_band_ghosts_fast(P.clone(), bcs, shape, flags))


def degree(dev, out, sums):
    shape = (cs.N_MAIN,) * 3
    gen = torch.Generator(device=dev).manual_seed(21)
    vals = torch.randn(shape, generator=gen, device=dev)
    G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev)
    on = torch.ones(2, dtype=torch.int32, device=dev)
    off = torch.zeros(2, dtype=torch.int32, device=dev)
    for label, d in (("degree7", 7), ("degree8", 8)):
        bcs = lsm.normalize_bcs(lsm.Extrapolation(d), 3)
        P = v2.pack_padded(vals, bcs)
        calls = {"K2": lambda: v2.refresh_ghosts_fast(P, bcs, shape),
                 "K4": lambda: bwd.fold_ghost_cotangent_fast(G, bcs, shape),
                 "K7on": lambda: bd.refresh_band_ghosts_fast(P, bcs, shape, on),
                 "K7off": lambda: bd.refresh_band_ghosts_fast(P, bcs, shape, off)}
        for key, fn in calls.items():
            timed(out, f"{label}_{key}", fn, per_launch=True)
        del P, calls
        torch.cuda.empty_cache()
    timed(out, "degree_clone", lambda: G.clone(memory_format=torch.contiguous_format))
    del G
    torch.cuda.empty_cache()
    if sums is not None:
        degree_sums(dev, sums)


def kind_of(kernel: str) -> str:
    """The flagship profile's kind of a kernel, by its name."""
    for kind, marks in (("K1pp", ("weno_stage", "march", "stage_")), ("K2", ("refresh",)),
                        ("tables", ("prog_table", "coef_table"))):
        if any(m in kernel for m in marks):
            return kind
    return "rest"


def flagship(dev, out):
    _, phi, _ = cs.zalesak(cs.N_MAIN, dev)
    term = lsm.AdvectionTerm(cs.rotation)
    for label, bc in (("periodic", lsm.Periodic()), ("degree8", lsm.Extrapolation(8))):
        p = lsm.MeshField(phi.values, phi.grid, bc)
        fresh = lambda: lsm.LevelSetEquation(terms=term, ic=p, integrator=lsm.RK3())
        fresh().integrate(1.0, max_steps=2)  # warm-up
        out[f"flagship_{label}_ms_per_step"] = cs.cuda_time(
            lambda: fresh().integrate(1.0, max_steps=10), warmup=0, reps=5) / 10
        eq = fresh()
        kernels = {}
        wall, busy = cs.profile_window(f"3 RK3 steps at {cs.N_MAIN}^3, {label}",
                                       lambda: eq.integrate(eq.t + 1.0, max_steps=3), kernels)
        out[f"flagship_{label}_wall_3steps"], out[f"flagship_{label}_busy_3steps"] = wall, busy
        for kind in ("K1pp", "K2", "tables", "rest"):
            out[f"flagship_{label}_{kind}_3steps"] = sum(ms for name, (ms, _) in kernels.items()
                                                   if kind_of(name) == kind)
        del eq, p
        torch.cuda.empty_cache()


PARTS = {"k2k4": k2k4, "k5": k5, "axis": axis_phases, "degree": degree, "flagship": flagship,
         "cells": cells}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("label", nargs="?", default=os.getcwd())
    ap.add_argument("--parts", default="k2k4,k5,axis")
    ap.add_argument("--save")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    out, sums = {}, {} if args.save else None
    for part in args.parts.split(","):
        fn = PARTS[part]
        if part in ("k5", "axis", "degree"):
            fn(dev, out, sums)
        else:
            fn(dev, out)
    if args.save:
        with open(args.save, "w") as f:
            json.dump(sums, f)
    print(cs.nvidia_smi())
    print("SHELLS", args.label, " ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main()
