"""The program's spans on the device trace's clock.

The program's spans (``repro_torch.obs.spans``) are stamped on
``engine.timing.monotonic``, which is ``time.perf_counter``: the clock of
``harness.common.clock``. ``DeviceTrace.mark()`` reads that clock
(``t_mark``) and at once opens the profiler's ``perfbench.mark`` event,
whose start is the stretch's start ``lo`` on the profiler's clock (us).
So a span at host time t lies at ``lo + (t - t_mark) * 1e6`` us in the
trace.

``idle_overlap_s`` gives the device-idle time that overlaps a set of
spans: the exact overlap of the spans' union with the gaps of the union
of the device's operations inside the stretch (every gap, as
``idle_share`` counts them), not a gap's midpoint. It is at most the
stretch's idle time.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


def to_trace_us(trace, t: float) -> float:
    """Host time ``t`` (program or benchmark clock) -> profiler time (us)."""
    return trace.lo + (t - trace.t_mark) * 1e6


def span_intervals(trace, records: Iterable) -> List[Interval]:
    """The records' extents on the profiler's clock, clipped to the
    profiled stretch; records wholly outside it are dropped."""
    out = []
    for r in records:
        a = max(to_trace_us(trace, r.t0), trace.lo)
        b = min(to_trace_us(trace, r.t1), trace.hi)
        if b > a:
            out.append((a, b))
    return out


def union(intervals: Iterable[Interval]) -> List[Interval]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(trace) -> List[Interval]:
    """The stretch's stretches with no device operation running (us)."""
    gaps, prev = [], trace.lo
    for a, b in trace._union() + [(trace.hi, trace.hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    return gaps


def overlap_us(xs: List[Interval], ys: List[Interval]) -> float:
    """Total length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_overlap_s(trace, records: Iterable) -> Optional[float]:
    """Device-idle seconds of the profiled stretch that overlap the
    records' union; None without a marked stretch."""
    if trace is None or trace.t_mark is None or trace.window_s <= 0:
        return None
    spans = union(span_intervals(trace, records))
    return overlap_us(spans, idle_gaps(trace)) * 1e-6


def idle_share_in(trace, records: Iterable) -> Optional[float]:
    """``idle_overlap_s`` over the stretch's length (%); None where no
    record falls in the stretch."""
    records = list(records)
    s = idle_overlap_s(trace, records)
    if s is None or not span_intervals(trace, records):
        return None
    return 100.0 * s / trace.window_s
