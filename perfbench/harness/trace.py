"""The device trace of a traced run: ``torch.profiler`` over a stretch of
the measured window, read back as device intervals and host operations.

``DeviceTrace.start()`` begins profiling one step before the counted
stretch (the profiler drops the first launches after it starts);
``mark()`` opens the counted stretch at a moment the device is quiet
(right after a synchronizing read); ``stop()`` closes it after a final
synchronize. ``summary()`` gives:

- ``busy_s``: the union of the device's operations (kernels, copies,
  sets) inside the stretch, ``window_s`` its length;
- ``device_ops``: device seconds by operation name, largest first;
- ``idle_gaps``: idle device seconds by what the host was doing then (the
  innermost host operation the profiler recorded at the gap's middle);
- ``time_of(patterns)``: the device seconds of the operations whose names
  hold any of ``patterns``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from harness.common import clock

MARK = "perfbench.mark"
END = "perfbench.end"
MIN_GAP_US = 2.0          # shorter gaps are launch jitter, not idleness
ANNOTATIONS = ("nccl:", "gloo:")   # c10d's ranges around a collective


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.t_mark = self.t_end = None      # host clock
        self.intervals: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        self.lo = self.hi = 0.0              # profiler clock, us

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def mark(self) -> None:
        self.t_mark = clock()
        with torch.profiler.record_function(MARK):
            pass

    def stop(self) -> None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.t_end = clock()
        with torch.profiler.record_function(END):
            pass
        self.prof.__exit__(None, None, None)
        self._read()

    def _read(self) -> None:
        events = self.prof.events()
        marks = [e.time_range.start for e in events if e.name == MARK]
        ends = [e.time_range.start for e in events if e.name == END]
        self.lo = min(marks) if marks else 0.0
        self.hi = max(ends) if ends else float("inf")
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith(ANNOTATIONS):
                continue                     # ranges, not device operations
            if e.device_type == cuda:
                if b > self.lo and a < self.hi:
                    self.intervals.append((max(a, self.lo), min(b, self.hi),
                                           e.name))
            elif e.name not in (MARK, END) and b > self.lo and a < self.hi:
                self.host.append((a, b, e.name))
        self.intervals.sort()
        self.host.sort()
        self._starts = [h[0] for h in self.host]
        self.prof = None

    # -- readings ---------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def _union(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for a, b, _ in self.intervals:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) * 1e-6

    def time_of(self, patterns: Iterable[str]) -> float:
        pats = tuple(patterns)
        return sum(b - a for a, b, n in self.intervals
                   if any(p in n for p in pats)) * 1e-6

    def device_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        for a, b, n in self.intervals:
            by[n] += (b - a) * 1e-6
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at profiler time ``t``."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(-1, i - 4000), -1):
            a, b, n = self.host[j]
            if b >= t:
                return n
        return "python (no profiled operation)"

    def idle_gaps(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        prev = self.lo
        for a, b in self._union() + [(self.hi, self.hi)]:
            if a - prev >= MIN_GAP_US:
                by[self._host_at(0.5 * (a + prev))] += (a - prev) * 1e-6
            prev = max(prev, b)
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def summary(self) -> Dict:
        return {"busy_s": self.busy_s, "window_s": self.window_s,
                "breakdown": {"device_ops": self.device_ops(),
                              "idle_gaps": self.idle_gaps()}}


def idle_share(trace: Optional[DeviceTrace]) -> Optional[float]:
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
