#!/usr/bin/env bash
# A/B of two trees of this repository on the band kernels, on one card, in
# turns: first, second, second, first. Each tree runs its own chip_smoke
# helpers in a process of its own and prints one line: the CUDA-event
# medians of K6 (the rotation streamed, tile-packed), K6'' (the rotation
# in-kernel), K6' (config C's normal motion, a streamed speed) and K8 (one
# re-tube of the candidates) on the band bench's 512^3 f32 sphere band; the
# end-to-end `integrate` ms per step of the band at 512^3 (FE and RK3, the
# rotation in-kernel), of config C (FE and RK3), of the band at 768^3 (FE)
# and of D2b (configuration 2 at 4096^2 as a 2D band, RK3); and the peak
# device memory of the 512^3 RK3 and 768^3 FE `integrate` calls.
#
# Each tree also writes SHA-256 digests to a temporary directory: of single
# K6, K6'' (both with aux) and K6' launches' outputs on the 512^3 band, and
# of the values and combined masks after 4 RK3 steps of the band stepper on
# the off-axis sphere, whose band moves and reaches the face x = 1 (K6''
# with K8 every step; K6 on the stream route; config C's K6'); the last
# lines say whether the two trees' digests are equal, and where they are
# not, the largest difference of the values.
#
# From the repository root, on a machine with one H100:
#   git archive <parent> | tar -x -C _archive/parent
#   bash tools/ab_band.sh _archive/parent .
set -euo pipefail
first=${1:?first tree}
second=${2:?second tree}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
outs=$(mktemp -d)
trap 'rm -rf "$outs"' EXIT
tag() { echo "$outs/$(echo "$1" | tr -c 'A-Za-z0-9' _)"; }
for tree in "$first" "$second" "$second" "$first"; do
  (cd "$tree" && python3 - "$tree" "$(tag "$tree")" <<'EOF'
import hashlib
import inspect
import os
import sys
import torch
import chip_smoke as cs
import lsm_tpu_torch as lsm
from lsm_tpu_torch.core.narrowband import box_dilate
from lsm_tpu_torch.integrators.band_fused import FusedBandStepper
from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import weno_v2 as v2

dev = torch.device("cuda", 0)
out, bits, values = {}, {}, {}
nb = cs.sphere_band(512, dev)
dt = 0.25 * nb.grid.min_spacing
st = FusedBandStepper((lsm.AdvectionTerm(cs.spin),), nb, lsm.ForwardEuler())
s = st.pack(nb)
P, O = s.bufs
prog = st.stage_terms(s, 0.0)
u = tuple(c.contiguous() for c in st._slot_values(prog[0][0], s, 0.0))
where = v2.Where(st.lo)
args = (s.ids, s.band)
out["K6_ms"] = cs.cuda_time(lambda: bd.band_stage(P, O, *args, u, (0.0, 1.0, dt), None,
                                                  st.spacing, st.shape, st.tiles))
out["K6pp_ms"] = cs.cuda_time(lambda: bd.band_stage(P, O, *args, prog, (0.0, 1.0, dt), None,
                                                    st.spacing, st.shape, st.tiles, where))
A = P + 1e-3
bits["K6 aux"] = bd.band_stage(P, O.clone(), *args, u, (0.75, 0.25, 0.25 * dt), A, st.spacing,
                               st.shape, st.tiles)
bits["K6'' aux"] = bd.band_stage(P, O.clone(), *args, prog, (0.75, 0.25, 0.25 * dt), A,
                                 st.spacing, st.shape, st.tiles, where)
cids, count = bd.compact_ids(box_dilate(s.act, 1), st.total)
band = s.band.clone()
k8 = (P, band, cids, nb.nlayers, lsm.NarrowBandField.COMPUTE_HALO, st.shape, st.tiles)
# a tree from before the re-tube's redesign (this A/B's parent) takes no count
if "count" in inspect.signature(bd.band_retube_incremental).parameters:
    k8 = k8 + (count,)
out["K8_ms"] = cs.cuda_time(lambda: bd.band_retube_incremental(*k8))
sc = FusedBandStepper((cs.c_term(nb),), nb, lsm.ForwardEuler())
s2 = sc.pack(nb)
tc = sc.stage_terms(s2, 0.0)
out["K6k_C_ms"] = cs.cuda_time(lambda: bd.band_stage(s2.bufs[0], s2.bufs[1], s2.ids, s2.band,
                                                     tc, (0.0, 1.0, dt), None, sc.spacing,
                                                     sc.shape, sc.tiles))
bits["K6' C"] = bd.band_stage(s2.bufs[0], s2.bufs[1].clone(), s2.ids, s2.band, tc,
                              (0.0, 1.0, dt), None, sc.spacing, sc.shape, sc.tiles)
del st, s, P, O, u, A, band, k8, sc, s2, tc
for integ in (lsm.ForwardEuler(), lsm.RK3()):
    name = type(integ).__name__
    out[f"band_{name}_ms"] = cs.integrate_ms_per_step(lsm.AdvectionTerm(cs.spin), nb, integ,
                                                      path="band")
    out[f"C_{name}_ms"] = cs.integrate_ms_per_step((cs.c_term(nb),), nb, integ, path="band")
out["band_RK3_peak_GiB"] = cs.peak_gib(lambda: cs.band_integrate(nb, lsm.RK3(), 10))
# trajectories: 4 RK3 steps on the off-axis sphere (its band moves, reaches x = 1)
nbo = cs.sphere_band(512, dev, center=(0.5, 0.0, 0.0))
for key, terms in (("K6''+K8", (lsm.AdvectionTerm(cs.spin),)),
                   ("K6+K8", (lsm.AdvectionTerm(cs.spin_polar),)),
                   ("K6' C+K8", (cs.c_term(nbo),))):
    so, state = cs.run_band_stepper(FusedBandStepper, nbo, lsm.RK3(), dt, 4, terms=terms)
    bits[f"{key} values"] = so.unpack(state).values
    bits[f"{key} band"] = state.band
    del so, state
del nb, nbo
torch.cuda.empty_cache()
nbx = cs.sphere_band(768, dev)
out["band768_FE_ms"] = cs.integrate_ms_per_step(lsm.AdvectionTerm(cs.spin), nbx,
                                                lsm.ForwardEuler(), path="band")
out["band768_FE_peak_GiB"] = cs.peak_gib(lambda: cs.band_integrate(nbx, lsm.ForwardEuler(), 10))
del nbx
torch.cuda.empty_cache()
terms, nb2, integ = cs.d2b(4096, dev)
out["D2b_ms"] = cs.integrate_ms_per_step(terms, nb2, integ, path="band")
tag = sys.argv[2]
os.makedirs(tag, exist_ok=True)
with open(os.path.join(tag, "sha256.txt"), "w") as fh:
    for key, val in bits.items():
        fh.write(f"{key}\t{hashlib.sha256(val.cpu().numpy().tobytes()).hexdigest()}\n")
torch.save({k: v.cpu() for k, v in bits.items()}, os.path.join(tag, "bits.pt"))
print("AB", sys.argv[1], " ".join(f"{k} {v}" for k, v in out.items()), flush=True)
EOF
  )
done
python3 - "$(tag "$first")" "$(tag "$second")" <<'EOF'
import os
import sys
import torch
a_dir, b_dir = sys.argv[1:3]
a, b = (dict(line.rstrip("\n").split("\t") for line in open(os.path.join(d, "sha256.txt")))
        for d in (a_dir, b_dir))
ta, tb = (torch.load(os.path.join(d, "bits.pt")) for d in (a_dir, b_dir))
for key in a:
    same = a[key] == b.get(key)
    diff = "" if same else (
        f", largest difference {float((ta[key].double() - tb[key].double()).abs().max()):.3e}")
    print(f"AB {key}: sha256 {a[key][:16]} vs {b.get(key, '')[:16]}, equal bit for bit: {same}"
          f"{diff}", flush=True)
EOF
