"""The traced window: ``torch.profiler`` over the measured calls, read in
memory (no trace file is written), reduced to what the per-layer readers
take.

The benchmark's own spans mark the window (``bench.window``) and each call
into the program (``bench.call``), so that a trace which lost events shows:
the spans counted must equal the calls made, and the device's busy time may
not exceed the window's wall time.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")

Event = Tuple[str, int, int]  # name, start ns, end ns


@dataclass
class Window:
    """One traced window: its device work, the host's runtime calls and
    operators, and the benchmark's spans, in the profiler's clock (ns)."""
    start: int
    end: int
    kernels: List[Event] = field(default_factory=list)
    copies: List[Event] = field(default_factory=list)
    runtime: List[Event] = field(default_factory=list)
    host_ops: List[Event] = field(default_factory=list)
    calls: int = 0

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def device_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's kernel and copy intervals, clipped to
        the window."""
        spans = sorted((max(s, self.start), min(e, self.end))
                       for _, s, e in self.kernels + self.copies if e > self.start and s < self.end)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.device_intervals()) * 1e-9

    def syncs(self) -> int:
        return sum(1 for name, _, _ in self.runtime if name.startswith(SYNC_CALLS))

    def breakdown(self, top: int = 10):
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing in them (the innermost host
        operator or runtime call under the gap's midpoint)."""
        per_op = {}
        for name, s, e in self.kernels + self.copies:
            per_op[name] = per_op.get(name, 0) + (e - s)
        ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
        host = sorted(self.host_ops + self.runtime, key=lambda ev: ev[1])
        starts = [ev[1] for ev in host]
        gaps = {}
        prev = self.start
        for s, e in self.device_intervals() + [(self.end, self.end)]:
            if s > prev:
                mid = (s + prev) // 2
                label = "python (no operator)"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(-1, i - 400), -1):
                    if host[j][2] >= mid:
                        label = host[j][0]
                        break
                gaps[label] = gaps.get(label, 0) + (s - prev)
            prev = max(prev, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v * 1e-9] for n, v in ops],
                "idle_gaps": [[n, v * 1e-9] for n, v in idle]}


class Tracer:
    """A profiler over the window when ``enabled``; otherwise the spans and
    the window cost nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.window: Optional[Window] = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(name):
            yield

    @contextlib.contextmanager
    def profiling(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        try:
            with self.span("bench.window"):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            self.prof.stop()
        self.window = read_window(self.prof)
        self.prof = None


def _span(ev) -> Tuple[int, int]:
    """An event's start and end in ns."""
    if hasattr(ev, "start_ns"):
        s = ev.start_ns()
        return s, s + ev.duration_ns()
    s = ev.start_us() * 1000
    return s, s + ev.duration_us() * 1000


def read_window(prof) -> Window:
    """The events of ``prof`` inside the benchmark's ``bench.window`` span:
    the card's kernels and copies (device events), the host's CUDA runtime
    and driver calls (host events named ``cu...``) and operators (the other
    host events)."""
    from torch.autograd import DeviceType

    spans, rest = [], []
    win = None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        on_card = ev.device_type() == DeviceType.CUDA
        s, e = _span(ev)
        if name.startswith("bench."):
            if not on_card and name == "bench.window":
                win = (s, e)
            elif not on_card and name == "bench.call":
                spans.append((s, e))
            continue
        rest.append((on_card, name, s, e))
    if win is None:
        raise RuntimeError("the trace holds no bench.window span")
    w = Window(win[0], win[1])
    w.calls = sum(1 for s, e in spans if s >= win[0] and e <= win[1])
    for on_card, name, s, e in rest:
        if e < w.start or s > w.end:
            continue
        if on_card:
            (w.copies if name.startswith(("Memcpy", "Memset")) else w.kernels).append((name, s, e))
        elif name.startswith("cu"):
            w.runtime.append((name, s, e))
        else:
            w.host_ops.append((name, s, e))
    return w
