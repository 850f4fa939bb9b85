#!/usr/bin/env bash
# A/B of K11 (the general path's 2D stage), K7 (the band's gated ghost
# refresh) and K2 (the ghost refresh whose threads K7 shares) on two trees
# of this repository, on one card, in turns: first,
# second, second, first. Each tree runs tools/general_band.py (this tree's
# copy, against that tree's package and chip_smoke helpers) in a process of
# its own and prints one line (GENBAND <tree> ...):
#  - K11 at 4096^2 on D2h's stage inputs, without and with aux; K7 at 512^3
#    on the band cells' buffer and K7's 2D entry on D2b's, flags on and off:
#    K2 3D on that buffer (Extrapolation(2), Periodic) and K2 2D on D2b's
#    (f32, f64): the CUDA-event median, back to back, and the profiler's
#    device time a call;
#  - integrate ms per step of D2h, the 512^3 band RK3 and D2b.
# The first run of each tree also saves K11's outputs, K7's on scribbled
# shells under the four flags and K2's; then the two trees' outputs are compared (per
# tensor: equal bits, elements that differ, largest difference), and
# tools/sass_diff.py lists the kernels whose machine code differs between
# the trees (and counts those that are identical).
#
# From the repository root, on a machine with one H100:
#   git archive <parent> | tar -x -C _archive/parent
#   bash tools/ab_general_band.sh _archive/parent .
set -euo pipefail
first=${1:?first tree}
second=${2:?second tree}
tool=$(cd "$(dirname "$0")" && pwd)/general_band.py
sass=$(cd "$(dirname "$0")" && pwd)/sass_diff.py
out=$(mktemp -d)
trap 'rm -rf "$out"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run=0
for tree in "$first" "$second" "$second" "$first"; do
  run=$((run + 1))
  save=()
  if [ "$run" -le 2 ]; then save=(--save "$out/run$run.pt"); fi
  (cd "$tree" && python3 "$tool" "$tree" --cells --k2 "${save[@]}") 2>&1 \
    | grep -E "^GENBAND|Error|error" || true
done
python3 - "$out/run1.pt" "$out/run2.pt" <<'PY'
import sys
import torch

a, b = torch.load(sys.argv[1]), torch.load(sys.argv[2])
for key in a:
    x, y = a[key], b[key]
    view = torch.int32 if x.dtype == torch.float32 else torch.int64
    same = x.shape == y.shape and torch.equal(x.view(view), y.view(view))
    diff = float((x.double() - y.double()).abs().max()) if x.shape == y.shape else float("nan")
    print(f"BITS {key}: equal bits {same}, {int((x != y).sum()) if x.shape == y.shape else -1} "
          f"of {x.numel()} differ, max|diff| {diff:.3e}", flush=True)
PY
python3 "$sass" "$first" "$second" > "$out/sass.txt"
grep -v ": identical" "$out/sass.txt" || true
echo "SASS identical kernels: $(grep -c ": identical" "$out/sass.txt")"
