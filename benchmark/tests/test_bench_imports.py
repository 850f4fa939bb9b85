"""What a run loads and where it refuses to run."""

import json
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT

DRIVE = """
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from benchmark import harness
r = harness.run(Path({root!r}), {cell!r}, 5, 0.05, False, device="cpu", n_override=16)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(harness.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    for cell in ("zalesak512.rk3", "torus512.grad3"):
        out = subprocess.run([sys.executable, "-c", DRIVE.format(root=str(ROOT), cell=cell)],
                             capture_output=True, text=True, timeout=600, check=True)
        loaded, bad = out.stdout.strip().splitlines()[-2:]
        assert bad == "[]"
        names = eval(loaded)
        assert "lsm_tpu_torch" in names and "jax" not in names and "lsm_tpu" not in names


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "torus512.rk3",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result was printed: {line}")
