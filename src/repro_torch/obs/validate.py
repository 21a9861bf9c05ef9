"""CI gate for observability artifacts.

Validates a metrics JSONL sink against the ``obs.metrics`` schema and/or
a Chrome trace export against the trace-event shape (parses, has events,
contains the expected span names). Run by the bench-smoke job right
after the instrumented smoke training run::

    python -m repro_torch.obs.validate --metrics m.jsonl --trace t.json \
        --expect-spans engine.run,engine.step,engine.data_wait

Exit status: 0 = all artifacts valid, 1 = validation failure.
"""
from __future__ import annotations

import json
import sys
from typing import Optional, Sequence


def check_metrics(path, expect_series: Sequence[str] = ()) -> list:
    """Schema-validate the sink; returns failure strings (empty = ok)."""
    from repro_torch.obs.metrics import MetricRegistry, validate_jsonl
    try:
        n = validate_jsonl(path)
    except (ValueError, json.JSONDecodeError, OSError) as e:
        return [f"{path}: {e}"]
    print(f"{path}: {n} records valid (schema ok)")
    reg, _ = MetricRegistry.from_jsonl(path)
    return [f"{path}: expected series {name!r} missing or empty "
            f"(have: {', '.join(reg.names())})"
            for name in expect_series
            if not getattr(reg.get(name), "values", None)]


def check_trace(path, expect_spans: Sequence[str] = ()) -> list:
    """Parse the Chrome trace; returns failure strings (empty = ok)."""
    from repro_torch.obs.chrome_trace import load_span_names
    try:
        with open(path) as fh:
            doc = json.load(fh)
        events = doc["traceEvents"]
    except (KeyError, json.JSONDecodeError, OSError) as e:
        return [f"{path}: not a Chrome trace: {e}"]
    if not isinstance(events, list) or not events:
        return [f"{path}: traceEvents empty"]
    names = load_span_names(path)
    print(f"{path}: {len(events)} events, {len(names)} span names")
    missing = sorted(set(expect_spans) - set(names))
    return [f"{path}: expected span {m!r} absent "
            f"(have: {', '.join(names)})" for m in missing]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--metrics", default="", help="metrics .jsonl sink")
    ap.add_argument("--trace", default="", help="Chrome trace .json")
    ap.add_argument("--expect-spans", default="",
                    help="comma-separated span names the trace must "
                         "contain")
    ap.add_argument("--expect-series", default="",
                    help="comma-separated series the metrics sink must "
                         "contain non-empty")
    args = ap.parse_args(argv)
    if not args.metrics and not args.trace:
        ap.error("nothing to validate: pass --metrics and/or --trace")
    failures = []
    if args.metrics:
        failures += check_metrics(
            args.metrics,
            [s for s in args.expect_series.split(",") if s])
    if args.trace:
        failures += check_trace(
            args.trace, [s for s in args.expect_spans.split(",") if s])
    for f in failures:
        print(f"FAIL {f}", file=sys.stderr)
    if not failures:
        print("observability artifacts valid")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
