"""Typed per-step metric registry with a schema-validated JSONL sink
(a stdlib copy of the JAX package's ``repro/obs/metrics.py``).

Three metric types, each get-or-create by name (a name is permanently
bound to its first type — re-requesting it as another type is an error,
not a silent shadow):

- ``Counter`` — monotone event count (steps run, checkpoints written);
- ``Gauge``   — last-write-wins scalar (replay max staleness, mesh k);
- ``Series``  — an append-only per-step stream (``step_s``,
  ``data_wait_s``, ``h2d_s``, ``loss``, per-group service times, ...),
  each sample carrying its index and a clock timestamp so the
  Chrome-trace exporter can place it on the run timeline.

``MetricRegistry`` is what ``engine.timing.Telemetry`` is a facade over:
the engine's per-step wall-clock record and the run-level metrics stream
are the same data. The JSONL sink (``to_jsonl`` / ``from_jsonl``) is the
on-disk contract — every line validates against ``validate_record``
(kind-discriminated, versioned via ``SCHEMA_VERSION``), and CI's
observability smoke re-validates emitted files on every run.

Schema (one JSON object per line)::

    {"kind": "meta",    "schema": 1, "run": {<str: scalar>...}}
    {"kind": "counter", "name": str, "value": int}
    {"kind": "gauge",   "name": str, "value": number}
    {"kind": "sample",  "name": str, "index": int, "t": number|null,
     "value": number}
    {"kind": "note",    "msg": str}

The first line must be the ``meta`` header; ``counter``/``gauge`` lines
record final values, ``sample`` lines the full per-step streams in append
order.
"""
from __future__ import annotations

import json
import math
from typing import Callable, Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

_SCALAR = (str, int, float, bool, type(None))


def _default_clock() -> Callable[[], float]:
    from repro_torch.engine.timing import monotonic   # lazy (see obs.spans)
    return monotonic


class Counter:
    """Monotone event counter."""
    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> int:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        self.value += int(n)
        return self.value


class Gauge:
    """Last-write-wins scalar."""
    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)


class Series:
    """Append-only per-step stream; ``values[i]`` was recorded for step
    ``steps[i]`` at clock time ``times[i]`` (None when recorded without a
    clock, e.g. rehydrated from JSONL)."""
    __slots__ = ("name", "values", "steps", "times", "_clock")
    kind = "series"

    def __init__(self, name: str, clock: Optional[Callable] = None):
        self.name = name
        self.values: List[float] = []
        self.steps: List[int] = []
        self.times: List[Optional[float]] = []
        self._clock = clock

    def append(self, value: float, step: Optional[int] = None,
               t: Optional[float] = None) -> None:
        if step is None:
            step = len(self.values)
        if t is None and self._clock is not None:
            t = self._clock()
        self.values.append(float(value))
        self.steps.append(int(step))
        self.times.append(t)

    def __len__(self) -> int:
        return len(self.values)


class MetricRegistry:
    """Get-or-create typed metrics + deduplicated notes (module doc)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock if clock is not None else _default_clock()
        self._metrics: Dict[str, object] = {}
        self.notes: List[str] = []

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, self._clock) if cls is Series else cls(name)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {type(m).__name__}, "
                            f"requested as {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def series(self, name: str) -> Series:
        return self._get(name, Series)

    def note(self, msg: str) -> None:
        """Deduplicated free-text observation (``Telemetry.note``)."""
        msg = str(msg)
        if msg not in self.notes:
            self.notes.append(msg)

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._metrics))

    def get(self, name: str):
        return self._metrics.get(name)

    # -- JSONL sink ------------------------------------------------------

    def records(self, run: Optional[dict] = None):
        """Yield schema records (module doc) — header first, then final
        counter/gauge values, then every series sample in append order,
        then notes."""
        yield {"kind": "meta", "schema": SCHEMA_VERSION,
               "run": dict(run or {})}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Counter):
                yield {"kind": "counter", "name": name, "value": m.value}
            elif isinstance(m, Gauge) and m.value is not None:
                yield {"kind": "gauge", "name": name, "value": m.value}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Series):
                for v, s, t in zip(m.values, m.steps, m.times):
                    yield {"kind": "sample", "name": name, "index": s,
                           "t": t, "value": v}
        for msg in self.notes:
            yield {"kind": "note", "msg": msg}

    def to_jsonl(self, path, run: Optional[dict] = None) -> int:
        """Write the validated record stream; returns the line count."""
        n = 0
        with open(path, "w") as fh:
            for rec in self.records(run):
                validate_record(rec)
                fh.write(json.dumps(rec) + "\n")
                n += 1
        return n

    @staticmethod
    def from_jsonl(path) -> Tuple["MetricRegistry", dict]:
        """Rehydrate ``(registry, run_meta)`` from a validated sink file
        (sample timestamps are preserved, not re-clocked)."""
        reg = MetricRegistry()
        run: dict = {}
        with open(path) as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                validate_record(rec, where=f"{path}:{lineno}")
                kind = rec["kind"]
                if kind == "meta":
                    run = rec["run"]
                elif kind == "counter":
                    reg.counter(rec["name"]).inc(rec["value"])
                elif kind == "gauge":
                    reg.gauge(rec["name"]).set(rec["value"])
                elif kind == "sample":
                    reg.series(rec["name"]).append(
                        rec["value"], step=rec["index"], t=rec["t"])
                elif kind == "note":
                    reg.note(rec["msg"])
        return reg, run


# ---------------------------------------------------------------------------
# schema validation (dependency-free; jsonschema is not in the image)
# ---------------------------------------------------------------------------

#: kind -> {field: validator}; every listed field is required and no
#: other fields are allowed (strict schema — additions bump the version).
_FIELDS = {
    "meta": {"schema": lambda v: v == SCHEMA_VERSION,
             "run": lambda v: isinstance(v, dict) and all(
                 isinstance(k, str) and isinstance(x, _SCALAR)
                 for k, x in v.items())},
    "counter": {"name": lambda v: isinstance(v, str) and v,
                "value": lambda v: isinstance(v, int)
                and not isinstance(v, bool) and v >= 0},
    "gauge": {"name": lambda v: isinstance(v, str) and v,
              "value": lambda v: _is_num(v)},
    "sample": {"name": lambda v: isinstance(v, str) and v,
               "index": lambda v: isinstance(v, int)
               and not isinstance(v, bool) and v >= 0,
               "t": lambda v: v is None or _is_num(v, finite=True),
               "value": lambda v: _is_num(v)},
    "note": {"msg": lambda v: isinstance(v, str)},
}


def _is_num(v, finite: bool = False) -> bool:
    ok = isinstance(v, (int, float)) and not isinstance(v, bool)
    return ok and (not finite or math.isfinite(v))


def validate_record(rec, where: str = "") -> None:
    """Raise ``ValueError`` unless ``rec`` matches the JSONL schema."""
    ctx = f" ({where})" if where else ""
    if not isinstance(rec, dict):
        raise ValueError(f"record is not an object{ctx}: {rec!r}")
    kind = rec.get("kind")
    fields = _FIELDS.get(kind)
    if fields is None:
        raise ValueError(f"unknown record kind {kind!r}{ctx}")
    extra = set(rec) - set(fields) - {"kind"}
    missing = set(fields) - set(rec)
    if extra or missing:
        raise ValueError(f"{kind} record fields: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}{ctx}")
    for field, check in fields.items():
        if not check(rec[field]):
            raise ValueError(
                f"bad {kind}.{field} value {rec[field]!r}{ctx}")


def validate_jsonl(path) -> int:
    """Validate every line of a sink file (header-first enforced);
    returns the record count."""
    n = 0
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            validate_record(rec, where=f"{path}:{lineno}")
            if n == 0 and rec["kind"] != "meta":
                raise ValueError(f"{path}: first record must be the meta "
                                 f"header, got {rec['kind']!r}")
            n += 1
    if n == 0:
        raise ValueError(f"{path}: empty metrics file")
    return n
