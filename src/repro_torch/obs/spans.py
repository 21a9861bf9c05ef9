"""Nested host-side span tracing — zero-cost when disabled (a copy of the
JAX package's ``repro/obs/spans.py``; in the port the serving loop's
``serve.*`` spans and the grouped round's ``round.*`` spans use it too).

A *span* is a named wall-clock interval on the host timeline: the engine
wraps each phase of a training round (data wait, dispatch, block) in one,
the cluster prober and the conv-tile autotuner wrap their probes, and the
Chrome-trace exporter (``obs.chrome_trace``) turns the record stream into
a Perfetto-viewable flame graph. All spans use the repo's one clock,
``engine.timing.monotonic`` (resolved lazily to keep ``repro.obs``
importable on its own).

Two tracer implementations share one interface:

- ``NullTracer`` (the default ``current()`` tracer): ``span()`` returns a
  single shared no-op context manager — no allocation, no clock read, no
  lock. Instrumented hot paths pay ~one attribute lookup + call when
  tracing is off, which is what lets the engine keep its spans compiled
  in unconditionally (the bench gate holds the step time to the
  whole-run baseline).
- ``Tracer``: records ``SpanRecord``s. Nesting depth and parent linkage
  come from a per-thread stack (``threading.local``), so concurrently
  tracing threads (prefetch, probes) never corrupt each other's tree;
  the finished-record list is guarded by a lock. Each span also opens a
  ``torch.profiler.record_function`` range of its name, so a profile
  taken while the tracer records carries the program's phases on the
  profiler's own clock (the profiler lists such ranges as user
  annotations). Instants open no range.

Usage::

    tracer = Tracer()
    with install(tracer):            # or: Engine(tracer=tracer)
        with span("engine.step", step=i) as sp:
            ...
            sp.set(loss=0.42)        # attrs attached on exit
    tracer.records()                 # -> tuple of SpanRecord
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Tuple


def _default_clock() -> Callable[[], float]:
    # lazy: obs must not import the engine package at module import time
    # (engine.timing imports obs.metrics for the Telemetry facade)
    from repro_torch.engine.timing import monotonic
    return monotonic


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span. Times are raw clock seconds (the exporter
    rebases them); ``depth``/``parent`` give the per-thread nesting tree,
    ``tid`` the thread the span ran on."""
    name: str
    t0: float
    t1: float
    depth: int
    tid: int
    index: int                 # commit order within the tracer
    parent: Optional[int]      # index of the enclosing span, if any
    attrs: Dict[str, object]

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """Shared no-op context manager — the entire cost of a disabled span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every ``span()`` is the same no-op object."""
    enabled = False

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **attrs) -> None:
        return None

    def records(self) -> Tuple[SpanRecord, ...]:
        return ()


class _Span:
    """Context manager recording one interval on the owning tracer."""
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_depth", "_parent",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        """Attach attrs (e.g. results only known at exit)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tr = self._tracer
        stack = tr._stack()
        self._depth = len(stack)
        self._parent = stack[-1] if stack else None
        stack.append(tr._reserve())
        self._range = tr._record_function(self.name)
        self._range.__enter__()
        self._t0 = tr._clock()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t1 = tr._clock()
        self._range.__exit__(*exc)
        index = tr._stack().pop()
        tr._commit(SpanRecord(
            name=self.name, t0=self._t0, t1=t1, depth=self._depth,
            tid=threading.get_ident(), index=index, parent=self._parent,
            attrs=self.attrs))
        return False


class Tracer:
    """Recording tracer (module docstring). ``clock`` defaults to
    ``engine.timing.monotonic`` — one clock repo-wide, so span times line
    up with the metric registry's sample timestamps."""
    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock if clock is not None else _default_clock()
        self._lock = threading.Lock()
        self._records: list = []
        self._next = 0
        self._local = threading.local()
        from torch.profiler import record_function
        self._record_function = record_function
        self.t_origin = self._clock()    # export rebase point

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _reserve(self) -> int:
        with self._lock:
            i = self._next
            self._next += 1
        return i

    def _commit(self, rec: SpanRecord) -> None:
        with self._lock:
            self._records.append(rec)

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration annotation (e.g. one gradient-exchange bucket's
        layout) at the current time and nesting depth."""
        t = self._clock()
        stack = self._stack()
        self._commit(SpanRecord(
            name=name, t0=t, t1=t, depth=len(stack),
            tid=threading.get_ident(), index=self._reserve(),
            parent=stack[-1] if stack else None, attrs=attrs))

    def records(self) -> Tuple[SpanRecord, ...]:
        """Finished spans in commit (end-time) order."""
        with self._lock:
            return tuple(self._records)

    def span_names(self) -> Tuple[str, ...]:
        return tuple(sorted({r.name for r in self.records()}))


# ---------------------------------------------------------------------------
# current-tracer plumbing: instrumented call sites that cannot thread a
# tracer argument (autotuner probes, cluster probes) go through here.
# ---------------------------------------------------------------------------

_CURRENT = NullTracer()


def current():
    """The installed tracer (a ``NullTracer`` unless one was installed)."""
    return _CURRENT


def install(tracer):
    """Install ``tracer`` as ``current()``. Usable two ways: plainly
    (returns the previous tracer) or as a context manager restoring the
    previous tracer on exit."""
    return _Installed(tracer)


class _Installed:
    """Return value of ``install``: already installed; optionally a CM."""

    def __init__(self, tracer):
        global _CURRENT
        self.previous = _CURRENT
        _CURRENT = tracer

    def __enter__(self):
        return _CURRENT

    def __exit__(self, *exc):
        global _CURRENT
        _CURRENT = self.previous
        return False


def span(name: str, **attrs):
    """``current().span(...)`` — the one-liner for instrumented call
    sites; a shared no-op when tracing is disabled."""
    return _CURRENT.span(name, **attrs)


def instant(name: str, **attrs) -> None:
    _CURRENT.instant(name, **attrs)


@contextmanager
def maybe_traced(enable: bool):
    """Install a fresh ``Tracer`` for the block iff ``enable``; yields the
    tracer (or the null tracer)."""
    if not enable:
        yield _CURRENT
        return
    tracer = Tracer()
    with install(tracer):
        yield tracer
