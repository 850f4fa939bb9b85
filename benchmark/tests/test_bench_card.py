"""Each cell once on the card, through the benchmark's own command."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT

CELLS = [w["name"] for w in harness.load_manifest(ROOT)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "3141592653", "--seconds", "2", "--trace", str(trace)], cwd=ROOT,
                         capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    c = harness.resolve(ROOT, cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(result["metrics"]) == want
