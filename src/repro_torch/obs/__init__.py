"""Run observability: span tracing, typed metrics, Chrome-trace export and
the run-environment stamp.

- ``obs.spans``        nested thread-safe span tracer, zero-cost when off
- ``obs.metrics``      counters/gauges/series + schema-validated JSONL
- ``obs.chrome_trace`` spans + metrics + EventTraces -> Perfetto
- ``obs.meta``         torch/CUDA/device stamp and its comparability rule
- ``obs.report``       recompute the planner's T(g,alloc) from a run
- ``obs.validate``     the artifact gate (metrics sink, Chrome trace)

``obs.report`` and ``obs.validate`` are imported by their users: importing
them here would shadow their ``python -m`` entry points.
"""
from repro_torch.obs import spans
from repro_torch.obs.chrome_trace import chrome_trace, export_chrome_trace
from repro_torch.obs.meta import env_mismatches, run_metadata
from repro_torch.obs.metrics import (Counter, Gauge, MetricRegistry, Series,
                                     validate_jsonl, validate_record)
from repro_torch.obs.spans import NullTracer, Tracer
