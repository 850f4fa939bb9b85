"""The readings the limits of ``cells/<cell>.json`` are set from, on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,...
        [--control-seeds 1,2,3] [--seconds 0.1] [--out <file.json>]

For each seed the cell runs as a run does (set-up, a short window of
``--seconds``, the judgement), and its numbers are the program's readings;
the largest over the seeds is a limit's lower reading. For each control seed
the reference itself, computed in bfloat16 (the precision below the
configurations' float32), takes the program's place on the same inputs, and
its numbers are the control's readings; the smallest is a limit's upper
reading. All seeds share one process and one set-up of the kernels. The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def reference_readings(outcome, dtype) -> dict:
    """The numbers of the reference computed in ``dtype``, put in the
    program's place on the inputs ``outcome`` was judged on: in bfloat16 it
    is the control; in the configuration's own dtype it is a plain
    implementation at the program's precision, a second witness."""
    from benchmark import drivers
    from benchmark import reference as ref

    ev = outcome.evidence
    low = ev["prob"].with_dtype(dtype)
    if "want" not in ev:
        out = {}
        for tag in ("start", "last"):
            x0, t0, max_steps, want, dt_ref, n_ref, _ = ev[tag]
            got, t1, n = ref.integrate(x0, t0, ev["tf"], max_steps, low)
            out.update(drivers.forward_gaps(tag, got, t1 - t0, n, want, dt_ref, n_ref))
        return out
    streams = [None if s is None else s.to(dtype) for s in ev["streams"]]
    loss, g, gs = ref.rollout_grad(ev["phi0"], ev["dt"], ev["nsteps"], low, streams)
    return drivers.gradient_gaps([loss], [g] + [x for x in gs if x is not None], ev["want"],
                                 ev["names"])


def where_worst(outcome) -> dict:
    """Where the program's answer lies farthest from the reference's: the
    node, both values, the reference's largest magnitude and the relative
    L2 gap, for each compared tensor."""
    import torch

    ev = outcome.evidence
    pairs = ([(f"grad_{i}", g, w) for i, (g, w) in enumerate(zip(
        ev["got"], [ev["want"][1]] + [x for x in ev["want"][2] if x is not None]))]
        if "want" in ev else [(f"state_{tag}", ev[tag][6], ev[tag][3]) for tag in ("start", "last")])
    out = {}
    for name, got, want in pairs:
        d = (got.double() - want.double()).abs()
        i = int(d.argmax())
        idx = [int(v) for v in torch.unravel_index(torch.tensor(i), tuple(d.shape))]
        out[name] = {"node": idx, "got": float(got.reshape(-1)[i]), "want": float(want.reshape(-1)[i]),
                     "max_abs_want": float(want.double().abs().max()),
                     "rel_l2": float(torch.linalg.vector_norm(got.double() - want.double())
                                     / torch.linalg.vector_norm(want.double()))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness", action="store_true",
                    help="also read the reference in the configuration's dtype on control seeds")
    ap.add_argument("--dtype", default=None, help="run the configuration in this dtype")
    ap.add_argument("--seconds", type=float, default=0.1)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import drivers, harness
    from benchmark.tracing import Tracer

    cell = harness.resolve(ROOT, args.workload)
    if args.dtype:
        cell.config["dtype"] = args.dtype
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        ctx = harness.Context(cell.config, cell.traffic, seed, args.seconds, args.device,
                              Tracer(False), args.n, keep=seed in control,
                              reference_dtype=cell.reference_dtype)
        out = drivers.DRIVERS[cell.traffic["driver"]](ctx)
        row = {"seed": seed, "program": out.checks, "units": out.units,
               "window_s": out.window_s}
        if seed in control:
            row["where"] = where_worst(out)
            row["control"] = reference_readings(out, torch.bfloat16)
            if args.witness:
                row["witness"] = reference_readings(out, {"float32": torch.float32, "float64":
                                                          torch.float64}[cell.config["dtype"]])
        del out
        if args.device == "cuda":
            torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "limits": cell.limits,
               "program_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    ctl = [r["control"] for r in rows if "control" in r]
    if ctl:
        summary["control_min"] = {k: min(c[k] for c in ctl) for k in ctl[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
