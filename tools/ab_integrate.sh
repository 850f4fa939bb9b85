#!/usr/bin/env bash
# A/B of the end-to-end `integrate` step time of two trees of this repository
# on one card, in turns: first, second, second, first. Each tree runs its own
# chip_smoke.integrate_ms_per_step (512^3 Zalesak, streamed rotation, FE and
# RK3, 10 steps per call, median of 20 calls) in a process of its own.
#
# From the repository root, on a machine with one H100:
#   git archive <parent> | tar -x -C _archive/parent
#   bash tools/ab_integrate.sh _archive/parent .
set -euo pipefail
first=${1:?first tree}
second=${2:?second tree}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for tree in "$first" "$second" "$second" "$first"; do
  (cd "$tree" && python3 -c "
import sys, torch, chip_smoke as cs, lsm_tpu_torch as lsm
grid, phi, vel = cs.zalesak(512, torch.device('cuda', 0))
term = lsm.AdvectionTerm(vel)
fe = cs.integrate_ms_per_step(term, phi, lsm.ForwardEuler())
rk3 = cs.integrate_ms_per_step(term, phi, lsm.RK3())
print('AB', sys.argv[1], 'FE_integrate_ms', fe, 'RK3_integrate_ms', rk3, flush=True)
" "$tree")
done
