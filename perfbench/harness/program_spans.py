"""What the serving loop's and the grouped round's span metrics read: the
program's span records (``repro_torch.obs.spans``), chosen by name and by
the name of their parent span.

A ``program_span`` metric reads the spans outside the profiled stretch,
by the rule of ``decode_step_ms.serve``: ended a second or more before
the mark, or begun at or after the stretch's end (the queue wait reads
the admissions before the profiler started only: ``before_profiler``).
A ``device_trace``
metric reads those inside it, through ``harness.span_clock``. Where the
program records no such span, every reader here finds nothing and returns
None.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from harness import span_clock

#: the children whose time a span's self time leaves out
DECODE_PARTS = ("serve.decode.upload", "serve.decode.dispatch")
ITERATION_PARTS = ("serve.prefill", "serve.decode_step")


def outside(ctx, r) -> bool:
    tr = ctx.trace
    if tr is None or tr.t_mark is None:
        return True
    return r.t1 <= tr.t_mark - 1.0 or r.t0 >= tr.t_end


def before_profiler(ctx) -> float:
    """Host time before which the profiler had not started: a second
    before the mark, and before the decode step in which the serving
    runner started the profiler (the step before the mark's). Starting
    and stopping the profiler stalls the loop for seconds while requests
    keep arriving, so a request that waited across either stall, or
    behind the backlog that the stop's stall leaves, has a wait that is
    the profiler's, not the program's."""
    tr = ctx.trace
    if tr is None or tr.t_mark is None:
        return float("inf")
    starts = sorted(r.t0 for r in ctx.spans
                    if r.name == "serve.decode_step" and r.t0 < tr.t_mark)
    return min([tr.t_mark - 1.0] + starts[-2:-1])


def named(ctx, name: str, parent: Optional[str] = None) -> List:
    """Records called ``name`` (whose parent is called ``parent``)."""
    if parent is None:
        return [r for r in ctx.spans if r.name == name]
    names = {r.index: r.name for r in ctx.spans}
    return [r for r in ctx.spans
            if r.name == name and names.get(r.parent) == parent]


def children(ctx, names) -> Dict[int, List]:
    """Parent index -> its child records called one of ``names``."""
    out: Dict[int, List] = {}
    for r in ctx.spans:
        if r.name in names and r.parent is not None:
            out.setdefault(r.parent, []).append(r)
    return out


def self_times_ms(ctx, name: str, parts, need=()) -> List[float]:
    """Self times (ms) of the ``name`` spans outside the stretch: each
    duration less its children called one of ``parts``. Only spans whose
    children hold every name of ``need`` count."""
    kids = children(ctx, parts)
    out = []
    for r in named(ctx, name):
        mine = kids.get(r.index, [])
        if not outside(ctx, r) or \
                not set(need) <= {k.name for k in mine}:
            continue
        out.append(1e3 * (r.duration_s - sum(k.duration_s for k in mine)))
    return out


def median(xs) -> Optional[float]:
    return statistics.median(xs) if xs else None


def idle_share(ctx, name: str, parent: Optional[str] = None):
    """Device-idle time of the profiled stretch that overlaps the ``name``
    spans (under ``parent``), over the stretch's length (%)."""
    return span_clock.idle_share_in(ctx.trace, named(ctx, name, parent))
