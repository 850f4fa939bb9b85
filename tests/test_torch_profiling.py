"""The port's ``utils.profiling`` on the CPU: JAX's ``test_step_monitor`` on
``lsm_tpu_torch``, ``StepMonitor``'s records against JAX's on the same 32^2
float64 run, its summary's keys and its log line, ``timed`` (with ``out``,
printed, an error inside it) and ``trace`` writing a Chrome trace."""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu_torch as T
from lsm_tpu.models import shapes as jshapes
from lsm_tpu.utils import StepMonitor as JStepMonitor
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.utils import StepMonitor, timed, trace
from lsm_tpu_torch.utils.checkpoint import field_from_numpy

SQUARE = ((-1.0, -1.0), (1.0, 1.0), (32, 32))


def _jvel(xs, t):
    return (jnp.ones_like(xs[0] + xs[1]), jnp.zeros_like(xs[0] + xs[1]))


def _tvel(xs, t):
    return (torch.ones_like(xs[0] + xs[1]), torch.zeros_like(xs[0] + xs[1]))


def _observables(mod):
    return {"volume": lambda e: e.volume(), "perimeter": lambda e: mod.perimeter(e.state)}


@pytest.fixture(scope="module")
def runs():
    """The same 32^2 f64 run (a circle carried along x, Periodic, RK3) under
    JAX's monitor and the port's."""
    jphi = J.sample(jshapes.circle(radius=0.5), J.Grid(*SQUARE), J.Periodic())
    tphi = field_from_numpy(np.array(jphi.values), T.Grid(*SQUARE), T.Periodic(), device="cpu")
    jmon, tmon = JStepMonitor(_observables(J)), StepMonitor(_observables(T))
    J.LevelSetEquation(terms=(J.AdvectionTerm(_jvel),), ic=jphi).integrate(0.1, posthook=jmon)
    T.LevelSetEquation(terms=(T.AdvectionTerm(_tvel),), ic=tphi).integrate(0.1, posthook=tmon)
    return jmon, tmon


def test_step_monitor():
    grid = T.Grid(*SQUARE)
    phi = T.sample(tshapes.circle(radius=0.5), grid, T.Periodic(), dtype=torch.float64,
                   device="cpu")
    eq = T.LevelSetEquation(terms=(T.AdvectionTerm(_tvel),), ic=phi, bc=T.Periodic())
    mon = StepMonitor(observables={"volume": lambda e: e.volume()})
    eq.integrate(0.1, posthook=mon)
    assert mon.nsteps > 0
    s = mon.summary()
    assert s["steps"] == mon.nsteps
    assert abs(s["volume_final"] - np.pi * 0.25) < 1e-2
    out = {}
    with timed("x", out=out):
        pass
    assert "x" in out


def test_step_monitor_records_match_jax(runs):
    jmon, tmon = runs
    assert tmon.nsteps == jmon.nsteps > 3
    np.testing.assert_allclose(tmon.ts, jmon.ts, rtol=1e-12, atol=0)
    for name in ("volume", "perimeter"):
        assert all(isinstance(v, float) for v in tmon.records[name])
        np.testing.assert_allclose(tmon.records[name], jmon.records[name], rtol=1e-12, atol=0)
    assert len(tmon.times) == tmon.nsteps - 1 and all(t >= 0 for t in tmon.times)


def test_summary_keys_match_jax(runs):
    jmon, tmon = runs
    js, ts = jmon.summary(), tmon.summary()
    assert set(ts) == set(js) == {"steps", "mean_step_s", "total_s", "volume_final",
                                  "perimeter_final"}
    assert ts["steps"] == js["steps"] and ts["volume_final"] == tmon.records["volume"][-1]
    assert StepMonitor().summary() == JStepMonitor().summary() == {"steps": 0.0}


def test_log_every_prints_jax_line(capsys):
    class Eq:
        current_time = 0.0

    eq = Eq()
    lines = {}
    for tag, cls in (("jax", JStepMonitor), ("torch", StepMonitor)):
        mon = cls({"volume": lambda e: torch.tensor(0.125 + e.current_time, dtype=torch.float64)
                   if tag == "torch" else jnp.asarray(0.125 + e.current_time)}, log_every=2)
        for step in range(5):
            eq.current_time = 0.1 * step
            mon(eq)
        lines[tag] = capsys.readouterr().out
    assert lines["torch"] == lines["jax"]
    assert lines["torch"].splitlines() == ["[step 2] t=0.1 volume=0.225",
                                           "[step 4] t=0.3 volume=0.425"]


def test_timed_with_out_and_printed(capsys):
    out = {}
    with timed("block", out=out):
        sum(range(1000))
    assert set(out) == {"block"} and 0.0 <= out["block"] < 10.0
    assert capsys.readouterr().out == ""
    with timed("printed"):
        pass
    assert re.fullmatch(r"\[printed\] \d+\.\d\d ms\n", capsys.readouterr().out)
    with timed("nosync", sync=False, out=out):
        pass
    assert "nosync" in out


def test_timed_propagates_errors(capsys):
    out = {}
    with pytest.raises(ZeroDivisionError):
        with timed("bad", out=out):
            1 / 0
    with pytest.raises(KeyError):
        with timed("bad2"):
            {}["missing"]
    assert out == {} and capsys.readouterr().out == ""


def test_trace_writes_chrome_trace(tmp_path):
    logdir = tmp_path / "prof"
    x = torch.randn(64, 64, dtype=torch.float64)
    with trace(str(logdir)) as d:
        torch.linalg.qr(x)
    assert d == str(logdir)
    files = list(logdir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("linalg_qr" in str(e.get("name", "")) for e in events)


def test_trace_stops_and_writes_when_the_region_raises(tmp_path):
    with pytest.raises(RuntimeError, match="inside"):
        with trace(str(tmp_path)):
            torch.ones(3).sum()
            raise RuntimeError("inside")
    assert len(list(tmp_path.glob("*.json"))) == 1
    with trace(str(tmp_path / "again")):  # the profiler was stopped: a second one starts
        torch.ones(3).sum()
    assert len(list((tmp_path / "again").glob("*.json"))) == 1
