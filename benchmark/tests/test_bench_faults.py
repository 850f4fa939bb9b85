"""A run driven on the CPU at a small size, the look for a card skipped:
sound, it comes out correct; with the timed path broken underneath, or with
the reference in bfloat16 in the program's place (the control), it does
not. The cells have no batch to halve and no exchange between chips, so
those faults have no place here."""

import torch
import pytest

import lsm_tpu_torch.ops.weno_v2 as v2
from lsm_tpu_torch.integrators.fused import FusedStepper
from benchmark import calibrate, drivers, harness
from benchmark.tests.conftest import ROOT
from benchmark.tracing import Tracer

N = 24
CELLS = ["zalesak512.rk3", "torus512.rk3", "zalesak512.grad20", "torus512.grad3"]


def run(cell):
    return harness.run(ROOT, cell, 1234567891011, 0.05, False, device="cpu", n_override=N)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert {"setup_s", "peak_gib"} <= set(r["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_caught(cell, monkeypatch):
    monkeypatch.setattr(FusedStepper, "step", lambda self, P, t, dt, dt_value=None: P)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(cell, monkeypatch):
    real = v2.fused_step_stage

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        bump = torch.zeros_like(out)
        bump[(slice(v2.GHOST + N // 2, v2.GHOST + N // 2 + 1),) * 3] = 0.5
        return out + bump

    monkeypatch.setattr(v2, "fused_step_stage", altered)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    c = harness.resolve(ROOT, cell)
    ctx = harness.Context(c.config, c.traffic, 99, 0.05, "cpu", Tracer(False), N, keep=True,
                          reference_dtype=c.reference_dtype)
    out = drivers.DRIVERS[c.traffic["driver"]](ctx)
    control = calibrate.reference_readings(out, torch.bfloat16)
    assert all(v <= c.limits[k] for k, v in out.checks.items())
    assert any(not v <= c.limits[k] for k, v in control.items())
