"""One run of one cell: resolve the cell by its name in ``BENCHMARK.json``,
drive it, and print its result line.

Everything a cell is made of is found by name: the configuration's file
(``configs/<config>.json``, the path ``BENCHMARK.json`` gives), the traffic
mix (``traffic/<traffic>.json``), the cell's limits and the precision its
reference computes in (``cells/<cell>.json``: ``limits``, ``reference_dtype``,
float64 when absent)
and each per-layer metric's reader (``metrics/<metric>.py``, else
``metrics/<part before the first dot>.py``). A cell that a later change
adds is files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from . import drivers
from .inputs import DTYPES
from .tracing import Tracer

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lsm_tpu")
GIB = float(1 << 30)


class CellError(RuntimeError):
    """The manifest or a cell's files do not resolve."""


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: list
    per_layer: list
    reference_dtype: torch.dtype = torch.float64


def _metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: Path, name: str) -> Cell:
    """The cell ``name`` of the manifest under ``root`` with its files."""
    man = load_manifest(root)
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise CellError(f"no workload named {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in man["configs"]}
    if w["config"] not in configs:
        raise CellError(f"workload {name!r} names the unknown configuration {w['config']!r}")
    bench = root / "benchmark"
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    judge = json.loads((bench / "cells" / f"{name}.json").read_text())
    return Cell(name, w, config, traffic, judge["limits"],
                [m for m in man["end_to_end"] if _metric_applies(m, name)],
                [m for m in man["per_layer"] if _metric_applies(m, name)],
                DTYPES[judge.get("reference_dtype", "float64")])


def reader(root: Path, metric: str) -> Callable:
    """The ``read(window, outcome)`` of a per-layer metric's own file."""
    metrics = root / "benchmark" / "metrics"
    for stem in (metric, metric.split(".")[0]):
        path = metrics / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise CellError(f"no reader for the per-layer metric {metric!r}")


@dataclass
class Context:
    """What a driver is given."""
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    device: str
    tracer: Tracer
    n_override: Optional[int] = None
    keep: bool = False
    reference_dtype: torch.dtype = torch.float64
    #: seconds since the process started at points of the set-up
    marks: Dict[str, float] = field(default_factory=dict)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(root: Path, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        n_override: Optional[int] = None) -> dict:
    """Drive the cell once and return its result line (a dict, ``checks``
    last). ``n_override`` sets every axis's node count (tests only)."""
    cell = resolve(root, name)
    driver = drivers.DRIVERS[cell.traffic["driver"]]
    tracer = Tracer(trace)
    ctx = Context(cell.config, cell.traffic, int(seed), float(seconds), device, tracer,
                  n_override, reference_dtype=cell.reference_dtype)
    ctx.marks["harness started"] = drivers.process_age()
    out = driver(ctx)
    print(f"{name}: {out.calls} calls, {out.units} {out.unit}s in {out.window_s:.3f} s; "
          f"set-up {out.setup_s:.2f} s; judged in {out.judge_s:.1f} s", file=sys.stderr)
    print("set-up: " + ", ".join(f"{k} at {v:.2f} s" for k, v in ctx.marks.items()),
          file=sys.stderr)
    missing = set(out.checks) ^ set(cell.limits)
    if missing:
        raise CellError(f"numbers and limits differ for {name}: {sorted(missing)}")
    checks = {k: {"value": v, "limit": float(cell.limits[k])} for k, v in out.checks.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(out.peak_bytes)}
    result = {"correct": correct, "attempted": out.calls, "failed": 0}
    metrics = {}
    if not trace:
        per_unit_ms = out.window_s * 1e3 / out.units
        values = {"step_ms": per_unit_ms if out.unit == "step" else None,
                  "grad_ms": per_unit_ms if out.unit == "call" else None,
                  "peak_gib": out.peak_bytes / GIB, "setup_s": out.setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is None:
                raise CellError(f"{name} does not measure {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        w = tracer.window
        if w.calls != out.calls:
            raise RuntimeError(f"the trace holds {w.calls} of the {out.calls} calls")
        if w.busy_s > out.window_s:
            raise RuntimeError(f"the trace's device time {w.busy_s} s exceeds the window "
                               f"{out.window_s} s")
        for m in cell.per_layer:
            value = reader(root, m["name"])(w, out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = w.busy_s
        dev["window_s"] = w.window_s
    result["metrics"] = metrics
    result["device"] = dev
    if trace:
        result["breakdown"] = tracer.window.breakdown()
    result["checks"] = checks
    return result


def report(result: dict) -> None:
    """Each number compared beside its limit on standard error, last."""
    for k, c in result["checks"].items():
        mark = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {mark}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
