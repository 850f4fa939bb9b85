#!/usr/bin/env bash
# A/B of two trees of this repository's stage adjoint on one card, in turns:
# first, second, second, first. Each tree runs its own chip_smoke helpers in
# a process of its own and prints one line of CUDA-event medians at 512^3
# f32: K3 on the flagship's streamed stage-1 inputs, K3'' with the rotation
# in-kernel, K3' on config A's and config C's (dense) stage-1 inputs; then,
# unless KERNELS_ONLY=1, cell (a) (value_and_grad of one FE step, streamed),
# cell (b) (a 20-step RK3 rollout under remat, ms per step) and the kinds
# gradient (3 RK3 steps, ms per value_and_grad), each with its peak memory. Before that line each tree
# prints its ghost-shell kernel line (tools/ghost_shells.py, run from this
# script's tree on the other's sources): K2's 3D entry and the fold as that
# tree's stage backward runs it (a copy of the cotangent, then K4 in place;
# or K4 out of place alone), beside g.clone(), each by CUDA events, back to
# back and by device time, on the flagship's Periodic state and on config
# A's Extrapolation(2).
#
# From the repository root, on a machine with one H100:
#   git archive <parent> | tar -x -C _archive/parent
#   bash tools/ab_backward.sh _archive/parent .
set -euo pipefail
first=${1:?first tree}
second=${2:?second tree}
here=$(cd "$(dirname "$0")" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for tree in "$first" "$second" "$second" "$first"; do
  (cd "$tree" && python3 "$here/ghost_shells.py" "$tree")
  (cd "$tree" && python3 - "$tree" "${KERNELS_ONLY:-0}" <<'EOF'
import sys
import torch
import chip_smoke as cs
import lsm_tpu_torch as lsm
from lsm_tpu_torch.integrators.fused import FusedStepper
from lsm_tpu_torch.ops import weno_v2 as v2
from lsm_tpu_torch.ops import weno_v2_bwd as bwd

dev = torch.device("cuda", 0)
out = {}
n = 512
grid, phi, vel = cs.zalesak(n, dev)
shape, sp, bcs = grid.shape, grid.spacing, phi.bcs
fe = FusedStepper(lsm.AdvectionTerm(vel), phi, lsm.ForwardEuler())
P = fe.pack(phi.values)
u = fe.stage_terms(0.0)[0][1]
dt = 0.5 * float(lsm.compute_cfl(fe.terms, phi, 0.0))
G = torch.randn(v2.padded_shape(shape), generator=torch.Generator(device=dev).manual_seed(8),
                device=dev)
gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
coeffs = (0.0, 1.0, dt)
out["K3_ms"] = cs.cuda_time(lambda: bwd.stage_backward(P, u, coeffs, None, gf, sp, shape))
prog = cs.program_term("advection", cs.rotation)[0].coef_static
where = v2.Where(grid.lo, None, cs.T_STAGE)
out["K3pp_rotation_ms"] = cs.cuda_time(lambda: bwd.stage_backward(
    P, prog, coeffs, None, gf, sp, shape, where=where, need_dt=prog.depends_on_t))
del fe, P, u, G, gf
torch.cuda.empty_cache()
for label in ("A", "C"):
    stepper, Pk, terms, dtk = cs.k3k_inputs(label, n, dev)
    Gk = torch.randn(v2.padded_shape(stepper.shape),
                     generator=torch.Generator(device=dev).manual_seed(14), device=dev)
    gk = bwd.fold_ghost_cotangent_fast(Gk, stepper.bcs, stepper.shape)
    out[f"K3k_{label}_ms"] = cs.cuda_time(lambda: bwd.stage_backward_terms(
        Pk, terms, (0.0, 1.0, dtk), None, gk, stepper.spacing, stepper.shape))
    del stepper, Pk, terms, Gk, gk
    torch.cuda.empty_cache()
if sys.argv[2] != "1":
    phiv = phi.values.clone().requires_grad_()
    velv = vel.values.clone().requires_grad_()
    dt_a = 0.25 * grid.min_spacing

    def cell_a():
        loss = cs.fe_grad_loss(phiv, tuple(velv[d] for d in range(3)), bcs, sp, shape, dt_a)
        return torch.autograd.grad(loss, (phiv, velv))

    out["cellA_streamed_ms"] = cs.cuda_time(cell_a, reps=10)
    out["cellA_streamed_peak_GiB"] = cs.peak_gib(cell_a)
    cell_b = lambda: cs.rollout_grad(phi, phiv, dt_a, cs.ROLLOUT_STEPS, remat=True)
    out["cellB_ms_per_step"] = cs.cuda_time(cell_b, warmup=1, reps=5) / cs.ROLLOUT_STEPS
    out["cellB_peak_GiB"] = cs.peak_gib(cell_b)
    del phiv, velv, phi, vel
    torch.cuda.empty_cache()
    tphi = cs.torus_field(n, dev)
    s = cs.c_term(tphi).speed.values
    dtg = 0.5 * float(lsm.compute_cfl(cs.grad_kinds_terms(tphi, s), tphi, 0.0))
    grad_kinds = lambda: cs.grad_kinds(tphi, tphi.values.clone().requires_grad_(),
                                       s.clone().requires_grad_(), dtg, cs.GRAD_KINDS_STEPS)
    out["grad_kinds_ms"] = cs.cuda_time(grad_kinds, warmup=1, reps=3)
    out["grad_kinds_peak_GiB"] = cs.peak_gib(grad_kinds)
print("AB", sys.argv[1], " ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
EOF
  )
done
