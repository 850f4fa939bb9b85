"""Step timing, observability and profiler hooks (port of
:mod:`lsm_tpu.utils.profiling`).

- :class:`StepMonitor` — a posthook that records per-step wall time, the
  time of each accepted step, and any user-selected observables (volume,
  perimeter, band size, ...), with a compact report.
- :func:`trace` — context manager around ``torch.profiler`` writing a Chrome
  trace of the wrapped region.
- :func:`timed` — block timer that waits for the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["StepMonitor", "trace", "timed"]


class StepMonitor:
    """Posthook recording per-step timing and observables.

    >>> mon = StepMonitor(observables={"volume": lambda eq: eq.volume()})
    >>> eq.integrate(1.0, posthook=mon)
    >>> mon.summary()

    An observable may return a tensor on the card: ``float`` reads it back,
    so each observable costs one wait for the card per step.
    """

    def __init__(self, observables: Optional[Dict[str, Callable]] = None, log_every: int = 0):
        self.observables = observables or {}
        self.log_every = log_every
        self.times: List[float] = []
        self.ts: List[float] = []
        self.records: Dict[str, List[float]] = {k: [] for k in self.observables}
        self._last = None

    def __call__(self, eq):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now
        self.ts.append(eq.current_time)
        for name, fn in self.observables.items():
            self.records[name].append(float(fn(eq)))
        if self.log_every and len(self.ts) % self.log_every == 0:
            obs = ", ".join(f"{k}={v[-1]:.6g}" for k, v in self.records.items())
            print(f"[step {len(self.ts)}] t={eq.current_time:.6g} {obs}")

    @property
    def nsteps(self) -> int:
        return len(self.ts)

    def summary(self) -> Dict[str, float]:
        out = {"steps": float(self.nsteps)}
        if self.times:
            out["mean_step_s"] = sum(self.times) / len(self.times)
            out["total_s"] = sum(self.times)
        for k, v in self.records.items():
            if v:
                out[f"{k}_final"] = v[-1]
        return out


@contextlib.contextmanager
def trace(logdir: str = "/tmp/lsm_tpu_torch_trace"):
    """Profile the wrapped region with ``torch.profiler``: the host's
    operators, and the card's kernels and copies when CUDA is available. On
    exit (also when the region raises) the card is waited for, the profiler
    stopped, and a Chrome trace (``chrome://tracing``, Perfetto) written into
    ``logdir`` as ``trace-<pid>-<ns>.json``. Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        if cuda and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        Path(logdir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(logdir) / f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def timed(label: str = "block", sync: bool = True, out: Optional[dict] = None):
    """Wall-time a block: into ``out[label]`` (seconds) when ``out`` is
    given, else printed as ``[label] N.NN ms``. With ``sync`` and CUDA in use
    in this process, the card is waited for on entry (earlier work is not
    charged to the block) and at exit (the block's own work is). A process
    that has not touched CUDA is not made to: its torch work is synchronous.
    An exception in the block propagates, and nothing is recorded."""
    if sync and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if sync and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if out is not None:
        out[label] = elapsed
    else:
        print(f"[{label}] {elapsed * 1e3:.2f} ms")
