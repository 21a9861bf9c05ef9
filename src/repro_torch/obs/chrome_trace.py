"""Chrome trace-event export — spans, metric series, and EventTraces in
one Perfetto-viewable JSON file (a stdlib copy of the JAX package's
``repro/obs/chrome_trace.py``).

Produces the legacy Chrome ``traceEvents`` JSON format (open at
https://ui.perfetto.dev or chrome://tracing). Three sources share the
file but not a timeline, so they land on separate *processes*:

- pid 0 ``host``: every finished span of a ``spans.Tracer`` as a
  complete ("X") event — one track (tid) per host thread, nesting
  rendered as the flame graph. Wall-clock microseconds, rebased to the
  earliest span so the trace starts at t=0.
- pid 0, track ``metrics``: every ``Series`` of a ``MetricRegistry`` as
  counter ("C") events at their recorded sample timestamps — step time,
  data wait, loss, ... plotted above the flame graph.
- pid 1 ``exec.trace``: an ``exec.trace.EventTrace`` with one track per
  worker group. Each commit t is a span from the time its
  ``read_version`` became available to its commit time, so staleness is
  the visible *length* of the bar and asynchrony the overlap between
  group tracks. NOTE: these are *simulated* seconds (the trace's own
  clock), deliberately a separate pid from the host wall-clock tracks.

``export_chrome_trace(path, tracer=..., metrics=..., event_trace=...)``
writes the combined file; each source is optional.
"""
from __future__ import annotations

import json
from typing import Optional

PID_HOST = 0
PID_EXEC = 1


def _meta(pid: int, tid: int, name: str, what: str = "thread_name") -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": what,
            "args": {"name": name}}


def span_events(tracer, t_origin: Optional[float] = None) -> list:
    """Tracer records -> complete events (one tid per host thread)."""
    records = tracer.records()
    if not records:
        return []
    if t_origin is None:
        t_origin = min(r.t0 for r in records)
    events = []
    tids = {}
    for r in records:
        tid = tids.setdefault(r.tid, len(tids))
        events.append({
            "name": r.name, "ph": "X", "pid": PID_HOST, "tid": tid,
            "ts": (r.t0 - t_origin) * 1e6,
            "dur": max(0.0, (r.t1 - r.t0) * 1e6),
            "args": {k: _jsonable(v) for k, v in r.attrs.items()},
        })
    events.append(_meta(PID_HOST, 0, "host", "process_name"))
    for ident, tid in tids.items():
        events.append(_meta(PID_HOST, tid,
                            "main" if tid == 0 else f"thread-{tid}"))
    return events


def metric_events(registry, t_origin: Optional[float] = None,
                  tid: int = 9999) -> list:
    """Registry series -> counter events at their sample timestamps.
    Samples recorded without a clock (rehydrated files) are skipped —
    they have no place on the timeline."""
    from repro_torch.obs.metrics import Series
    stamped = []
    for name in registry.names():
        m = registry.get(name)
        if isinstance(m, Series):
            stamped += [(t, name, v) for v, t in zip(m.values, m.times)
                        if t is not None]
    if not stamped:
        return []
    if t_origin is None:
        t_origin = min(t for t, _, _ in stamped)
    events = [{"name": name, "ph": "C", "pid": PID_HOST, "tid": tid,
               "ts": (t - t_origin) * 1e6, "args": {name: v}}
              for t, name, v in sorted(stamped)]
    events.append(_meta(PID_HOST, tid, "metrics"))
    return events


def event_trace_events(trace, name: str = "commit") -> list:
    """EventTrace -> one track per worker group (simulated time, pid 1).

    Commit t renders as a bar from the creation time of the model
    version it read (``commit_time[read_version - 1]``, 0.0 for version
    0) to ``commit_time[t]`` — bar length IS the read-to-commit window,
    so deep staleness is visually long and synchronous execution renders
    as non-overlapping bars.
    """
    events = [_meta(PID_EXEC, 0, "exec.trace (simulated time)",
                    "process_name")]
    ct = trace.commit_time
    for t in range(len(trace)):
        rv = int(trace.read_version[t])
        t_read = float(ct[rv - 1]) if rv > 0 else 0.0
        events.append({
            "name": f"{name} {t}", "ph": "X", "pid": PID_EXEC,
            "tid": int(trace.group[t]),
            "ts": t_read * 1e6,
            "dur": max(0.0, (float(ct[t]) - t_read) * 1e6),
            "args": {"commit": t, "read_version": rv,
                     "staleness": t - rv},
        })
    for gid in range(trace.num_groups):
        events.append(_meta(PID_EXEC, gid, f"group {gid}"))
    return events


def chrome_trace(tracer=None, metrics=None, event_trace=None) -> dict:
    """The combined trace document. Host spans and metric samples share
    one rebased wall-clock origin; the EventTrace keeps its own
    (simulated) clock on its own pid."""
    events = []
    t_origin = None
    if tracer is not None and tracer.records():
        t_origin = min(r.t0 for r in tracer.records())
    if metrics is not None:
        from repro_torch.obs.metrics import Series
        stamps = [t for name in metrics.names()
                  for m in [metrics.get(name)] if isinstance(m, Series)
                  for t in m.times if t is not None]
        if stamps:
            t_origin = min(stamps) if t_origin is None \
                else min(t_origin, min(stamps))
    if tracer is not None:
        events += span_events(tracer, t_origin)
    if metrics is not None:
        events += metric_events(metrics, t_origin)
    if event_trace is not None:
        events += event_trace_events(event_trace)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path, tracer=None, metrics=None,
                        event_trace=None) -> int:
    """Write the combined trace JSON; returns the event count."""
    doc = chrome_trace(tracer=tracer, metrics=metrics,
                       event_trace=event_trace)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])


def load_span_names(path) -> tuple:
    """Span/instant names present in an exported trace file (validation
    helper: parses the JSON and keeps only duration events)."""
    with open(path) as fh:
        doc = json.load(fh)
    return tuple(sorted({e["name"] for e in doc["traceEvents"]
                         if e.get("ph") == "X"}))


def _jsonable(v):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    return repr(v)
