"""p90 of the time from a request's arrival to its admission (ms), on the
server's clock: the ``queue_wait_s`` of the program's ``serve.admit``
instants made before the profiler started
(``harness.program_spans.before_profiler``). Requests admitted after the
profiled stretch are left out, unlike the spans of the other
``program_span`` readers: the stall of the profiler's stop, and the
backlog it leaves, lengthen their waits."""
from harness.common import quantile
from harness import program_spans as P


def read(ctx):
    until = P.before_profiler(ctx)
    xs = [float(r.attrs["queue_wait_s"]) for r in P.named(ctx, "serve.admit")
          if r.t0 <= until and "queue_wait_s" in r.attrs]
    return 1e3 * quantile(xs, 0.9) if xs else None
