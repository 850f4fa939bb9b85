"""Time the ghost-shell pair of this tree at 512^3 f32: K2's 3D refresh and the
fold of a stage output's cotangent (K4) as this tree's stage backward runs it,
beside ``g.clone()`` of the same buffer.

Run from the root of a tree of this repository (its own ``chip_smoke``
helpers and package), on a machine with one H100:

    python3 tools/ghost_shells.py [label]

Three states: the flagship's (the 512^3 Zalesak sphere, Periodic), config
A's (the torus, ``Extrapolation(2)``) and the sphere under mixed BCs with
``Extrapolation(7)`` (the most an edge or vertex ghost of K2 reads). For each, three readings of every
call: the CUDA-event median (``chip_smoke.cuda_time``), the time a call of 50
issued back to back (``back_to_back_ms``) and the profiler's device time a
call (``device_ms``), with the device time of each launch of a call by kernel
name. The calls: K2 on the packed state; "fold" as the backward runs it (a
tree whose K4 folds in place: ``clone`` and then K4; one whose K4 writes a new
buffer: K4 alone); K4 alone (in place on a buffer it has already folded, or
out of place); ``g.clone()``. Prints one line, ``SHELLS <label> key value
...``.
"""

from __future__ import annotations

import os
import re
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import lsm_tpu_torch as lsm  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402
from lsm_tpu_torch.ops import weno_v2_bwd as bwd  # noqa: E402


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


def main(label: str) -> None:
    dev = torch.device("cuda", 0)
    in_place = folds_in_place(dev)
    out = {}
    _, phi, _ = cs.zalesak(cs.N_MAIN, dev)
    torus = cs.torus_field(cs.N_MAIN, dev)
    mixed7 = lsm.normalize_bcs([(lsm.Extrapolation(7), lsm.Symmetry()), lsm.Periodic(),
                                (lsm.Symmetry(), lsm.Extrapolation(5))], 3)
    states = {"periodic": (phi.values, phi.bcs), "extrap2": (torus.values, torus.bcs),
              "mixed7": (phi.values, mixed7)}
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
            out[f"{name}_{key}_event"] = cs.cuda_time(fn)
            out[f"{name}_{key}_b2b"] = cs.back_to_back_ms(fn)
            out[f"{name}_{key}_device"] = cs.device_ms(fn)
            for i, (kernel, ms) in enumerate(launches_ms(fn)):
                m = re.search(r"(\w+)<", kernel)
                out[f"{name}_{key}_launch{i}[{m.group(1) if m else kernel.split()[0]}]"] = ms
        del P, G, calls, fold, k4, clone, values
        torch.cuda.empty_cache()
    print(cs.nvidia_smi())
    print("SHELLS", label, f"in_place={in_place}",
          " ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.getcwd())
