#!/usr/bin/env bash
# A/B of two trees of this repository on one card, in turns: first, second,
# second, first. Each tree runs its own chip_smoke helpers in a process of its
# own and prints one line: the end-to-end `integrate` ms per step of the
# 512^3 Zalesak main path (FE and RK3 with the rotation streamed, RK3 with it
# in-kernel as a callable; 10 steps per call, median of 20 calls), of the
# same in-kernel RK3 through `make_sharded_evolve(fused=True)` on 4 shards of
# the card (meshes (4, 1) and (2, 2)), of cell (b) (a 20-step RK3 rollout's
# gradient under remat, ms per step) and of D2 and D3 (configurations 2 and 3
# of `models.benchmarks`, the 2D embedding) at 4096^2; the CUDA-event medians
# of the advection-only K1 on its stage-1
# inputs and with aux, of K1'' with the rotation and with the vortex
# in-kernel, and of the advection-only K6 on the 512^3 sphere band. A tree
# that has the term kinds also times K1' on configs A, B (frozen and
# recomputed sign) and the kinds gradient's table (curvature + normal motion
# at a streamed speed) and on D4's 4096^2 embedding, K6' on config C, K10
# (with and without aux) on H's inputs, and end to end the RK3 `integrate`
# ms per step of A, B (frozen sign), B (recomputed), D4 and H (a posthook:
# the general path, K10) and the kinds gradient (ms per value_and_grad of
# its 3-step RK3 rollout under remat).
#
# Each tree also writes the SHA-256 of its K6' outputs (config C's stage, and
# A's terms on the off-axis sphere band) to a temporary directory; the last
# lines say whether the two trees' K6' outputs are equal bit for bit.
#
# From the repository root, on a machine with one H100:
#   git archive <parent> | tar -x -C _archive/parent
#   bash tools/ab_integrate.sh _archive/parent .
set -euo pipefail
first=${1:?first tree}
second=${2:?second tree}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
hashes=$(mktemp -d)
trap 'rm -rf "$hashes"' EXIT
bits() { echo "$hashes/$(echo "$1" | tr -c 'A-Za-z0-9' _).txt"; }
for tree in "$first" "$second" "$second" "$first"; do
  (cd "$tree" && python3 - "$tree" "$(bits "$tree")" <<'EOF'
import hashlib
import sys
import torch
import chip_smoke as cs
import lsm_tpu_torch as lsm
from lsm_tpu_torch import parallel as par
from lsm_tpu_torch.integrators.band_fused import FusedBandStepper
from lsm_tpu_torch.integrators.fused import FusedStepper
from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import weno_general as wg
from lsm_tpu_torch.ops import weno_v2 as v2

dev = torch.device("cuda", 0)
out = {}
grid, phi, vel = cs.zalesak(512, dev)
term = lsm.AdvectionTerm(vel)
out["FE_integrate_ms"] = cs.integrate_ms_per_step(term, phi, lsm.ForwardEuler())
out["RK3_integrate_ms"] = cs.integrate_ms_per_step(term, phi, lsm.RK3())
P = v2.pack_padded(phi.values, phi.bcs)
u = tuple(vel.values[d].contiguous() for d in range(3))
dt = 0.25 * grid.min_spacing
out["K1_ms"] = cs.cuda_time(lambda: v2.fused_stage(P, u, (0.0, 1.0, dt), None, grid.spacing,
                                                   grid.shape))
out["K1_aux_ms"] = cs.cuda_time(lambda: v2.fused_stage(P, u, (0.75, 0.25, 0.25 * dt), P,
                                                       grid.spacing, grid.shape))
where = v2.Where(grid.lo, None, cs.T_STAGE)
for name, fn in (("rotation", cs.rotation), ("vortex", cs.vortex3)):
    prog = (cs.program_term("advection", fn),)
    out[f"K1pp_{name}_ms"] = cs.cuda_time(lambda: v2.fused_stage(
        P, prog, (0.0, 1.0, dt), None, grid.spacing, grid.shape, where))
rot = lsm.AdvectionTerm(cs.rotation)
out["RK3_integrate_inkernel_ms"] = cs.integrate_ms_per_step(rot, phi, lsm.RK3())
for ms in cs.SHARDED_MESHES:
    ev = par.make_sharded_evolve(lsm.RK3(), cs.card_mesh(dev, ms), grid, fused=True,
                                 max_steps=cs.SHARDED_STEPS)
    sphi = par.shard_field(phi, cs.card_mesh(dev, ms))
    out[f"sharded_{ms[0]}x{ms[1]}_ms"] = cs.cuda_time(
        lambda: ev((rot,), sphi, 0.0, 1.0), warmup=1, reps=10) / cs.SHARDED_STEPS
    del ev, sphi
del P, u
torch.cuda.empty_cache()
phiv = phi.values.clone().requires_grad_()
out["cellB_ms_per_step"] = cs.cuda_time(
    lambda: cs.rollout_grad(phi, phiv, dt, cs.ROLLOUT_STEPS, remat=True),
    warmup=1, reps=5) / cs.ROLLOUT_STEPS
del phiv, phi, vel
torch.cuda.empty_cache()
for name in ("D2", "D3"):
    terms2, phi2, integ2 = cs.config(name, 4096, dev)
    out[f"{name}_integrate_ms"] = cs.integrate_ms_per_step(terms2, phi2, integ2)
    del terms2, phi2, integ2
torch.cuda.empty_cache()
nb = cs.sphere_band(512, dev)
st = FusedBandStepper((lsm.AdvectionTerm(cs.spin),), nb, lsm.ForwardEuler())
s = st.pack(nb)
xs = bd.tile_coords(s.ids, st.shape, st.tiles, st.spacing, st.lo, st.dtype)
ub = v2.eval_components(cs.spin(xs, 0.0), (st.capacity, *st.tiles), st.dtype, dev)
band_args = (s.ids, s.band)
out["K6_ms"] = cs.cuda_time(lambda: bd.band_stage(s.bufs[0], s.bufs[1], *band_args, ub,
                                                  (0.0, 1.0, dt), None, st.spacing, st.shape,
                                                  st.tiles))
if hasattr(cs, "a_terms"):  # a tree with the term kinds
    for key, field, terms_of in (
            ("K1'_A_ms", lambda: cs.torus_field(512, dev), lambda f: cs.a_terms()),
            ("K1'_B_frozen_ms", lambda: cs.torus_field(512, dev, wavy=True),
             lambda f: (lsm.EikonalReinitializationTerm.from_initial(f),))):
        f = field()
        sk = FusedStepper(terms_of(f), f, lsm.RK3())
        Pk = sk.pack(f.values)
        tk = sk.stage_terms(0.0)
        out[key] = cs.cuda_time(lambda: v2.fused_stage(Pk, tk, (0.0, 1.0, 1e-4), None,
                                                       sk.spacing, sk.shape))
        del f, sk, Pk, tk
    for key, field, terms_of in (
            ("K1'_B_none_ms", lambda: cs.torus_field(512, dev, wavy=True),
             lambda f: (lsm.EikonalReinitializationTerm(),)),
            ("K1'_kinds_grad_ms", lambda: cs.torus_field(512, dev),
             lambda f: cs.grad_kinds_terms(f, cs.c_term(f).speed.values))):
        f = field()
        sk = FusedStepper(terms_of(f), f, lsm.RK3())
        Pk, tk = sk.pack(f.values), sk.stage_terms(0.0)
        out[key] = cs.cuda_time(lambda: v2.fused_stage(Pk, tk, (0.0, 1.0, 1e-4), None,
                                                       sk.spacing, sk.shape))
        del f, sk, Pk, tk
    d4_terms, d4_phi, d4_integ = cs.config("D4", 4096, dev)
    sk = FusedStepper(d4_terms, d4_phi, d4_integ)
    Pk, tk = sk.pack(d4_phi.values), sk.stage_terms(0.0)
    out["K1'_D4_ms"] = cs.cuda_time(lambda: v2.fused_stage(Pk, tk, (0.0, 1.0, 1e-6), None,
                                                           sk.spacing, sk.shape))
    out["D4_integrate_ms"] = cs.integrate_ms_per_step(d4_terms, d4_phi, d4_integ)
    del d4_terms, d4_phi, d4_integ, sk, Pk, tk
    torch.cuda.empty_cache()
    f = cs.torus_field(512, dev)
    out["A_integrate_ms"] = cs.integrate_ms_per_step(cs.a_terms(), f, lsm.RK3())
    s_ = cs.c_term(f).speed.values
    dt_ = 0.5 * float(lsm.compute_cfl(cs.grad_kinds_terms(f, s_), f, 0.0))
    out["kinds_grad_ms"] = cs.cuda_time(lambda: cs.grad_kinds(
        f, f.values.clone().requires_grad_(), s_.clone().requires_grad_(), dt_,
        cs.GRAD_KINDS_STEPS), warmup=1, reps=3)
    del f, s_
    torch.cuda.empty_cache()
    f = cs.torus_field(512, dev, wavy=True)
    out["B_frozen_integrate_ms"] = cs.integrate_ms_per_step(
        (lsm.EikonalReinitializationTerm.from_initial(f),), f, lsm.RK3())
    out["B_none_integrate_ms"] = cs.integrate_ms_per_step(
        (lsm.EikonalReinitializationTerm(),), f, lsm.RK3())
    del f
    torch.cuda.empty_cache()
    grid_h, phi_h, vel_h = cs.zalesak(512, dev)
    Ph, uh = phi_h.pad(3), tuple(vel_h.values[d] for d in range(3))
    out["K10_ms"] = cs.cuda_time(lambda: wg.weno_stage_3d(Ph, uh, grid_h.spacing, grid_h.shape,
                                                          (0.0, 1.0, 1e-3)))
    out["K10_aux_ms"] = cs.cuda_time(lambda: wg.weno_stage_3d(
        Ph, uh, grid_h.spacing, grid_h.shape, (0.75, 0.25, 1e-3), phi_h.values))
    del Ph
    out["H_integrate_ms"] = cs.integrate_ms_per_step(lsm.AdvectionTerm(vel_h), phi_h, lsm.RK3(),
                                                     path=None, posthook=lambda e: None)
    del grid_h, phi_h, vel_h, uh
    torch.cuda.empty_cache()
    sc = FusedBandStepper((cs.c_term(nb),), nb, lsm.ForwardEuler())
    sc_state = sc.pack(nb)
    tc = sc.stage_terms(sc_state, 0.0)
    out["K6'_C_ms"] = cs.cuda_time(lambda: bd.band_stage(
        sc_state.bufs[0], sc_state.bufs[1], sc_state.ids, sc_state.band, tc, (0.0, 1.0, dt),
        None, sc.spacing, sc.shape, sc.tiles))
    bits = {"C": bd.band_stage(sc_state.bufs[0], sc_state.bufs[1].clone(), sc_state.ids,
                               sc_state.band, tc, (0.0, 1.0, dt), None, sc.spacing, sc.shape,
                               sc.tiles).cpu()}
    del sc, sc_state, tc
    nba = cs.sphere_band(512, dev, center=(0.5, 0.0, 0.0))
    sa = FusedBandStepper(cs.a_terms(), nba, lsm.ForwardEuler())
    sa_state = sa.pack(nba)
    bits["A off-axis"] = bd.band_stage(sa_state.bufs[0], sa_state.bufs[1].clone(), sa_state.ids,
                                       sa_state.band, sa.stage_terms(sa_state, 0.0),
                                       (0.0, 1.0, 1e-4), None, sa.spacing, sa.shape,
                                       sa.tiles).cpu()
    with open(sys.argv[2], "w") as fh:
        for key, val in bits.items():
            fh.write(f"{key}\t{hashlib.sha256(val.numpy().tobytes()).hexdigest()}\n")
    del nba, sa, sa_state
print("AB", sys.argv[1], " ".join(f"{k} {v}" for k, v in out.items()), flush=True)
EOF
  )
done
python3 - "$(bits "$first")" "$(bits "$second")" <<'EOF'
import os
import sys
if all(os.path.exists(p) for p in sys.argv[1:3]):
    a, b = (dict(line.rstrip("\n").split("\t") for line in open(p)) for p in sys.argv[1:3])
    for key in a:
        print(f"AB K6' {key}: the two trees' outputs equal bit for bit: {a[key] == b.get(key)}",
              flush=True)
EOF
