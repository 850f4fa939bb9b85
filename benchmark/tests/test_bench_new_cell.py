"""A cell added as new files and manifest entries runs through the harness
with no file of the benchmark edited."""

import json
import shutil

from benchmark import harness
from benchmark.tests.conftest import ROOT


def test_a_new_cell_is_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = {"name": "sphere_grow_64", "source": "a test",
           "grid": {"lo": [-1.0, -1.0, -1.0], "hi": [1.0, 1.0, 1.0], "n": [64, 64, 64]},
           "dtype": "float32", "bc": {"kind": "extrapolation", "degree": 1},
           "shape": {"kind": "torus", "center": [0.0, 0.0, 0.0], "major": 0.4, "minor": 0.25},
           "terms": [{"kind": "normal", "coef": 0.3}],
           "integrator": {"kind": "RK3", "cfl": 0.5}, "reduced": []}
    (bench / "configs" / "sphere_grow_64.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "short_chunks.json").write_text(json.dumps(
        {"driver": "integrate", "center_jitter_cells": 0.5, "tf": 1e6, "chunk_steps": 5,
         "warmup_steps": 1}))
    (bench / "cells" / "grow64.short.json").write_text(json.dumps({"limits": {
        "state_gap_start": 1e-4, "dt_gap_start": 1e-5, "steps_gap_start": 0.0,
        "state_gap_last": 1e-4, "dt_gap_last": 1e-5, "steps_gap_last": 0.0}}))
    (bench / "metrics" / "steps_per_call.py").write_text(
        "def read(window, outcome):\n    return outcome.units / outcome.calls\n")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "sphere_grow_64", "source": "a test",
                           "file": "benchmark/configs/sphere_grow_64.json", "reduced": [],
                           "why": "a test"})
    man["workloads"].append({"name": "grow64.short", "config": "sphere_grow_64",
                             "traffic": "short_chunks", "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"].append("grow64.short")
    man["per_layer"].append({"name": "steps_per_call", "unit": "steps/call", "better": "higher",
                             "source": "program_counter", "layer": "equation",
                             "moves": "step_ms", "workloads": ["grow64.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    r = harness.run(tmp_path, "grow64.short", 42, 0.05, False, device="cpu", n_override=20)
    assert r["correct"], r["checks"]
    assert {"step_ms", "peak_gib", "setup_s"} == set(r["metrics"])
    assert harness.reader(tmp_path, "steps_per_call") is not None
    for p, data in before.items():
        assert p.read_bytes() == data
