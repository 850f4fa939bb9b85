#!/usr/bin/env bash
# A/B of K5 (the shell zeroing) and K2's single-axis entry on two trees of
# this repository, on one card, in turns: first, second, second, first. Each
# tree runs tools/ghost_shells.py (this tree's copy, against that tree's
# package and chip_smoke helpers) in a process of its own and prints one line
# (SHELLS <tree> ...):
#  - K5 at 512^3 and 4096^2 on a random cotangent's buffer, K2's single-axis
#    phases (axis 2 at the (2, 2) mesh's shard 256x256x512, axes 1 and 2 at the
#    (4, 1) mesh's 128x512x512, buffers in turn out of L2), f32: the
#    CUDA-event median, back to back and the profiler's device time a call;
#  - the cells that run them, ms and peak GiB: cell (b) per RK3 step,
#    grad_kinds, grad2d and grad2d_kinds per value_and_grad, the sharded
#    512^3 RK3 flagship per step on the (4, 1) and (2, 2) meshes of the card.
# The first run of each tree also saves the SHA-256 of K5's outputs and of the
# single-axis phases' (every axis at both shard shapes, f32 and f64, Periodic
# and mixed BCs); then the two trees' are compared, and tools/sass_diff.py
# lists the kernels whose machine code differs between the trees (and counts
# those that are identical).
#
# From the repository root, on a machine with one H100:
#   git archive <parent> | tar -x -C _archive/parent
#   bash tools/ab_shells.sh _archive/parent .
set -euo pipefail
first=${1:?first tree}
second=${2:?second tree}
tool=$(cd "$(dirname "$0")" && pwd)/ghost_shells.py
sass=$(cd "$(dirname "$0")" && pwd)/sass_diff.py
out=$(mktemp -d)
trap 'rm -rf "$out"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run=0
for tree in "$first" "$second" "$second" "$first"; do
  run=$((run + 1))
  save=()
  if [ "$run" -le 2 ]; then save=(--save "$out/run$run.json"); fi
  (cd "$tree" && python3 "$tool" "$tree" --parts "${PARTS:-k5,axis,cells}" "${save[@]}") 2>&1 \
    | grep -E "^SHELLS|Error|error" || true
done
python3 - "$out/run1.json" "$out/run2.json" <<'PY'
import json
import sys

a, b = (json.load(open(path)) for path in sys.argv[1:])
for key in sorted(set(a) | set(b)):
    print(f"BITS {key}: equal bits {a.get(key) == b.get(key)}", flush=True)
PY
python3 "$sass" "$first" "$second" > "$out/sass.txt"
grep -v ": identical" "$out/sass.txt" || true
echo "SASS identical kernels: $(grep -c ": identical" "$out/sass.txt")"
