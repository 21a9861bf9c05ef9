"""Trace-driven asynchronous execution: ``EventTrace`` records from the
discrete-event simulators (request arrivals for serving, too), replayed as
real SGD updates (Python reference, a ring of stacked versions, or
closed-form fused runs)."""
from repro_torch.exec.replay import (replay_trace, replay_trace_fused,
                                     replay_trace_python, replay_trace_scan,
                                     replayed_momentum_experiment)
from repro_torch.exec.trace import EventTrace

__all__ = ["EventTrace", "replay_trace", "replay_trace_fused",
           "replay_trace_python", "replay_trace_scan",
           "replayed_momentum_experiment"]
