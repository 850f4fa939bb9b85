"""BENCHMARK.json against the contract it is written to, and every cell,
configuration, traffic mix and per-layer metric found by its name."""

import json
import re

import pytest

from benchmark import harness, inputs
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])


def test_names_units_and_bounds():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in MAN["end_to_end"])
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["unit"] == "%":
            assert m["name"].endswith("_roofline") or "." in m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.resolve(ROOT, cell)
    assert c.workload["chips"] == 1 and len(c.workload["why"]) <= 200
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(harness.reader(ROOT, m["name"]))
        e2e = {x["name"]: x for x in MAN["end_to_end"]}[m["moves"]]
        assert "workloads" not in e2e or cell in e2e["workloads"]
    assert c.limits and all(v >= 0 for v in c.limits.values())


def test_every_configuration_used_and_its_file_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used and set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("kind", ["RK2", "ForwardEuler", "rk3"])
def test_an_integrator_neither_side_runs_is_refused(kind):
    cfg = json.loads((ROOT / MAN["configs"][0]["file"]).read_text())
    assert inputs.rk3_cfl(cfg) == cfg["integrator"]["cfl"]
    cfg["integrator"]["kind"] = kind
    with pytest.raises(ValueError, match="RK3 only"):
        inputs.rk3_cfl(cfg)
