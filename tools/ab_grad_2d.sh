#!/usr/bin/env bash
# A/B of the dense 2D gradient on two trees of this repository, on one card,
# in turns: first, second, second, first. Each tree runs its own package in a
# process of its own and prints one line (TREE <tree> {...}):
#  - on the 4096^2 f32 stage inputs of the smoke's 2D gradient cells
#    (chip_smoke.grad2d_cell: the state as the stepper packs it, a random
#    folded cotangent), K3 2D (grad2d_streamed: the rotation streamed, du
#    written; with aux), K3'' 2D (grad2d: the rotation in-kernel; the vortex
#    with the stage time's cotangent) and K3' 2D (grad2d_kinds; and with a
#    program coefficient, the smoke's "K3' program + dt" list: a
#    time-dependent program speed beside a streamed curvature, on
#    grad2d_kinds' state with the stage time's cotangent): a
#    CUDA-event median (chip_smoke.cuda_time) and the profiler's device time a
#    call (chip_smoke.device_ms);
#  - grad2d, grad2d_streamed and grad2d_kinds: ms per value_and_grad (event
#    median of 5) and peak memory; D2, D3 and D4 `integrate` ms per step.
# The first run of each tree also saves the outputs of K3 2D, K3'' 2D and K3'
# 2D on those inputs; then the two trees' outputs are compared: per tensor
# whether the bits are equal, how many elements differ and the largest
# difference (dcoef: each entry's difference).
#
# From the repository root, on a machine with one H100:
#   git archive <parent> | tar -x -C _archive/parent
#   bash tools/ab_grad_2d.sh _archive/parent .
set -euo pipefail
first=${1:?first tree}
second=${2:?second tree}
out=$(mktemp -d)
trap 'rm -rf "$out"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run=0
for tree in "$first" "$second" "$second" "$first"; do
  run=$((run + 1))
  save=""
  if [ "$run" -le 2 ]; then save="$out/run$run.pt"; fi
  (cd "$tree" && python3 - "$tree" "$save" <<'EOF'
import json
import sys
import torch
import chip_smoke as cs
import lsm_tpu_torch as lsm
from lsm_tpu_torch.integrators.fused import FusedStepper
from lsm_tpu_torch.ops import weno_v2 as v2
from lsm_tpu_torch.ops import weno_v2_bwd as bwd

dev = torch.device("cuda", 0)
n = cs.N_2D
out, saved = {}, {}
G = torch.randn(v2.padded_shape((n, n)), generator=torch.Generator(device=dev).manual_seed(8),
                device=dev)
phi, terms_of, _, dt, _ = cs.grad2d_cell("grad2d", n, dev)
shape, sp = phi.shape, phi.spacing
gf = bwd.fold_ghost_cotangent_fast(G, phi.bcs, shape)
st = FusedStepper(terms_of(None), phi, lsm.RK3())
P = st.pack(phi.values)
coeffs = (0.0, 1.0, dt)
prog = st.entries[0][0].coef_static
vortex = FusedStepper((lsm.AdvectionTerm(cs.shapes.vortex_velocity(period=4.0)),), phi,
                      lsm.RK3()).entries[0][0].coef_static
sphi, sterms_of, _, _, _ = cs.grad2d_cell("grad2d_streamed", n, dev)
u = FusedStepper(sterms_of(None), sphi, lsm.RK3()).entries[0][1]
kphi, kterms_of, s, kdt, _ = cs.grad2d_cell("grad2d_kinds", n, dev)
kst = FusedStepper(kterms_of(s), kphi, lsm.RK3())
KP = kst.pack(kphi.values)
kgf = bwd.fold_ghost_cotangent_fast(G, kphi.bcs, shape)
pst = FusedStepper((lsm.NormalMotionTerm(lambda xs, t: 0.1 + 0.05 * xs[0] + 0.02 * t * xs[1]),
                    lsm.CurvatureTerm(lsm.MeshField(s, kphi.grid))), kphi, lsm.RK3())
calls = {
    "K3pp_2d": lambda: bwd.stage_backward(P, prog, coeffs, None, gf, sp, shape,
                                          where=v2.Where(st.lo, None, 0.0)),
    "K3pp_2d_vortex_dt": lambda: bwd.stage_backward(P, vortex, coeffs, None, gf, sp, shape,
                                                    where=v2.Where(st.lo, None, cs.T_STAGE),
                                                    need_dt=True),
    "K3_2d": lambda: bwd.stage_backward(P, u, coeffs, None, gf, sp, shape),
    "K3_2d_aux": lambda: bwd.stage_backward(P, u, (0.75, 0.25, dt), P, gf, sp, shape),
    "K3k_2d": lambda: bwd.stage_backward_terms(KP, kst.entries, (0.0, 1.0, kdt), None, kgf,
                                               kphi.spacing, shape),
    "K3k_2d_prog": lambda: bwd.stage_backward_terms(KP, pst.entries, (0.0, 1.0, kdt), None, kgf,
                                                    kphi.spacing, shape,
                                                    where=v2.Where(pst.lo, None, cs.T_STAGE),
                                                    need_dt=True),
}
for key, fn in calls.items():
    if sys.argv[2]:
        dP, du, dcoef, daux = fn()
        saved[key] = {"dP": dP.cpu(), "dcoef": dcoef.cpu(),
                      **{f"du{k}": d.cpu() for k, d in enumerate(du or ()) if d is not None},
                      **({"daux": daux.cpu()} if daux is not None else {})}
    out[f"{key}_ms"] = cs.cuda_time(fn)
    out[f"{key}_device_ms"] = cs.device_ms(fn)
if sys.argv[2]:
    torch.save(saved, sys.argv[2])
del saved, st, P, u, kst, pst, KP, gf, kgf, G
torch.cuda.empty_cache()
for name in cs.GRAD2D_CELLS:
    cphi, cterms_of, cs_, cdt, nsteps = cs.grad2d_cell(name, n, dev)
    call = lambda: cs.grad2d_value_and_grad(cphi, cterms_of, cs_, cdt, nsteps,
                                            cphi.values.clone().requires_grad_())
    call()
    out[f"{name}_ms"] = cs.cuda_time(call, warmup=1, reps=5)
    out[f"{name}_peak_gib"] = cs.peak_gib(call)
    del cphi, call
    torch.cuda.empty_cache()
for name in ("D2", "D3", "D4"):
    terms, phi, integ = cs.config(name, n, dev)
    path, _, _ = cs.TWOD[name]
    out[f"{name}_ms"] = cs.integrate_ms_per_step(terms, phi, integ, path=path)
    del terms, phi, integ
    torch.cuda.empty_cache()
print(f"TREE {sys.argv[1]} " + json.dumps({k: round(v, 4) for k, v in out.items()}), flush=True)
EOF
  ) 2>&1 | grep -E "^TREE|Error|error" || true
done
python3 - "$out/run1.pt" "$out/run2.pt" <<'EOF'
import sys
import torch

a, b = torch.load(sys.argv[1]), torch.load(sys.argv[2])
for key in a:
    for name in a[key]:
        x, y = a[key][name], b[key][name]
        diff = (x.double() - y.double()).abs()
        same = x.shape == y.shape and torch.equal(x.view(torch.int32 if x.dtype == torch.float32
                                                         else torch.int64),
                                                  y.view(torch.int32 if y.dtype == torch.float32
                                                         else torch.int64))
        scale = float(y.double().abs().max())
        line = (f"BITS {key} {name}: equal bits {same}, {int((x != y).sum())} of {x.numel()} "
                f"differ, max|diff| {float(diff.max()):.3e} (max|second| {scale:.3e})")
        if name == "dcoef":
            line += " " + " ".join(f"{float(p):.9e}/{float(q):.9e}" for p, q in zip(x, y))
        print(line, flush=True)
EOF
