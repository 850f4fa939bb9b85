#!/usr/bin/env bash
# A/B of two trees of this repository on one card, in turns: first, second,
# second, first, for the 2D cells. Each tree runs its own chip_smoke helpers
# in a process of its own and prints one line: the end-to-end `integrate` ms
# per step (10 steps per call, median of 20 calls) and the peak device memory
# (GiB, one integrate of 10 steps from a reset) of D1-D4, D2h and D2s
# (configurations 1-4 of `models.benchmarks` at 4096^2, D2h D2 with a
# posthook, D2s D2 with its rotation sampled on the grid and streamed, built
# here so that both trees run the same cell), of the 2D bands D2b and D4b and
# of three 3D cells (the 512^3 Zalesak RK3 with the rotation streamed and
# in-kernel, config A's torus RK3); D2's device-busy share over 3 RK3 steps
# (torch.profiler); and on D2's, D2s's, D3's and D4's stage-1 inputs, laid
# out as the tree's FusedStepper lays them out (the parent's (1, n0, n1)
# embedding, where D2s's velocity gains a zero component and K1 is the 3D
# march over one plane; the change's (n0+6, n1+6), two components and the 2D
# march), K1's stage and K2's refresh: ms a call between CUDA events, a call
# of 50 back to back, and the profiler's device time.
#
# From the repository root, on a machine with one H100:
#   git archive <parent> | tar -x -C _archive/parent
#   bash tools/ab_2d.sh _archive/parent .
set -euo pipefail
first=${1:?first tree}
second=${2:?second tree}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for tree in "$first" "$second" "$second" "$first"; do
  (cd "$tree" && python3 - "$tree" <<'EOF'
import json
import math
import sys
import torch
import chip_smoke as cs
import lsm_tpu_torch as lsm
from lsm_tpu_torch.integrators.fused import FusedStepper
from lsm_tpu_torch.models import benchmarks as bench
from lsm_tpu_torch.models import shapes
from lsm_tpu_torch.ops import weno_v2 as v2

dev = torch.device("cuda", 0)
TWOD = dict(cs.TWOD, D2s=("fused", None, {}))


def config(name):
    """D1-D4 and D2h as the tree's smoke builds them; D2s (D2, the rotation
    2 pi about (0.5, 0.5) sampled on the grid) the same on every tree."""
    if name != "D2s":
        return cs.config(name, cs.N_2D, dev)
    eq = bench.config2_zalesak(cs.N_2D, dtype=torch.float32, device=dev)
    rot = shapes.rigid_rotation_velocity((0.5, 0.5), 2.0 * math.pi)
    vel = lsm.sample(lambda *xs: rot(xs, 0.0), eq.state.grid, dtype=torch.float32, device=dev,
                     vector=True)
    return (lsm.AdvectionTerm(vel),), eq.state, eq.integrator


out = {}
for name in ("D1", "D2", "D2s", "D3", "D4", "D2h"):
    terms, phi, integ = config(name)
    path, _, kw = TWOD[name]
    kw = {"posthook": lambda e: None} if kw else {}
    out[f"{name}_ms"] = cs.integrate_ms_per_step(terms, phi, integ, path=path, **kw)
    out[f"{name}_GiB"] = cs.peak_gib(lambda: lsm.LevelSetEquation(
        terms=terms, ic=phi, integrator=integ).integrate(1.0, max_steps=10, **kw))
    if name == "D2":
        eq = lsm.LevelSetEquation(terms=terms, ic=phi, integrator=integ)
        wall, busy = cs.profile_window("D2: 3 RK3 steps",
                                       lambda: eq.integrate(eq.t + 1.0, max_steps=3))
        out["D2_busy_share"] = busy / wall
        del eq
    del terms, phi, integ
    torch.cuda.empty_cache()
for name in ("D2", "D2s", "D3", "D4"):
    terms, phi, integ = config(name)
    st = FusedStepper(terms, phi, integ)
    P, tt = st.pack(phi.values), st.stage_terms(0.0)
    dt = 0.5 * float(st.cfl(P, 0.0))
    k1 = lambda: v2.fused_stage(P, tt, (0.0, 1.0, dt), None, st.spacing, st.shape,
                                v2.Where(st.lo, None, 0.0))
    k2 = lambda: v2.refresh_ghosts_fast(P, st.bcs, st.shape)
    for key, fn in ((f"K1_{name}", k1), ("K2_D2", k2)) if name == "D2" else ((f"K1_{name}", k1),):
        out[f"{key}_ms"] = cs.cuda_time(fn)
        out[f"{key}_b2b_ms"] = cs.back_to_back_ms(fn)
        out[f"{key}_device_ms"] = cs.device_ms(fn)
    out[f"{name}_padded_MB"] = P.numel() * P.element_size() / 1e6
    out[f"{name}_velocity_MB"] = sum(a.numel() * a.element_size() for spec, arrs in tt
                                     for a in arrs) / 1e6
    del st, P, tt, terms, phi, integ
    torch.cuda.empty_cache()
for name, make in (("D2b", cs.d2b), ("D4b", cs.d4b)):
    terms, nb, integ = make(cs.N_2D, dev)
    out[f"{name}_ms"] = cs.integrate_ms_per_step(terms, nb, integ, path="band")
    del terms, nb, integ
    torch.cuda.empty_cache()
grid, phi, vel = cs.zalesak(512, dev)
out["RK3_512_stream_ms"] = cs.integrate_ms_per_step(lsm.AdvectionTerm(vel), phi, lsm.RK3())
out["RK3_512_inkernel_ms"] = cs.integrate_ms_per_step(lsm.AdvectionTerm(cs.rotation), phi,
                                                      lsm.RK3())
del grid, phi, vel
torch.cuda.empty_cache()
f = cs.torus_field(512, dev)
out["A_512_ms"] = cs.integrate_ms_per_step(cs.a_terms(), f, lsm.RK3())
print(f"TREE {sys.argv[1]} " + json.dumps({k: round(v, 4) for k, v in out.items()}), flush=True)
EOF
  ) 2>&1 | grep -E "^TREE|Error|error" || true
done
