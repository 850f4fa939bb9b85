"""Run one cell of the benchmark once, on the card this process sees:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It prints the cell's result as one JSON line, the last of its standard
output, and each number compared beside its limit as the last lines of its
standard error. It exits with another code than 0, and prints no result,
when there is no card, when the cell needs more cards than there are, when
the program cannot be found or fails, or when JAX or the JAX package has
been loaded by the time the window has closed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell = harness.resolve(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell.workload["chips"]):
        print(f"{args.workload} needs {cell.workload['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process, which the benchmark may not: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    harness.report(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
