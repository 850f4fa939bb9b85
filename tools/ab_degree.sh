#!/usr/bin/env bash
# A/B of the route for an Extrapolation of degree above 7 (the table route of
# K2, K4 and K7) on two trees of this repository, on one card, in turns:
# first, second, second, first. Each tree runs tools/ghost_shells.py (this
# tree's copy, against that tree's package and chip_smoke helpers) in a
# process of its own and prints one line (SHELLS <tree> ...):
#  - K2, K4, K7 flags on and K7 flags off at 512^3 f32 under Extrapolation(8)
#    (the table route) beside the by-value route's Extrapolation(7), and
#    g.clone() of the same cotangent: the CUDA-event median, back to back and
#    the profiler's device time a call, and each launch of a call by kernel
#    name;
#  - with PARTS=degree,flagship (the default), the 512^3 Zalesak RK3
#    integrate (rotation in-kernel) under Periodic and Extrapolation(8): ms a
#    step, and a profile of 3 steps split by kind of kernel.
# The first run of each tree also saves the SHA-256 of the table route's
# outputs (K2 3D, each axis and 2D, K4 3D and 2D, K7 3D and 2D under each
# gate; degrees 8, 11, mixed and 19, f32 and f64); then the two trees' are
# compared, and tools/sass_diff.py lists the kernels whose machine code
# differs between the trees (and counts those that are identical; a kernel
# that gained a trailing int template argument 0 is compared with the one it
# replaced: E=Li0EE).
#
# From the repository root, on a machine with one H100:
#   git archive <parent> | tar -x -C _archive/parent
#   bash tools/ab_degree.sh _archive/parent .
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
  (cd "$tree" && python3 "$tool" "$tree" --parts "${PARTS:-degree,flagship}" "${save[@]}") 2>&1 \
    | grep -E "^SHELLS|^\[profile\]|Error|error" || true
done
python3 - "$out/run1.json" "$out/run2.json" <<'PY'
import json
import sys

a, b = (json.load(open(path)) for path in sys.argv[1:])
same = sorted(k for k in set(a) | set(b) if a.get(k) == b.get(k))
for key in sorted(set(a) | set(b)):
    if a.get(key) != b.get(key):
        print(f"BITS {key}: equal bits False", flush=True)
print(f"BITS equal: {len(same)} of {len(set(a) | set(b))} outputs", flush=True)
PY
python3 "$sass" "$first" "$second" E=Li0EE > "$out/sass.txt"
grep -v ": identical" "$out/sass.txt" || true
echo "SASS identical kernels: $(grep -c ": identical" "$out/sass.txt")"
