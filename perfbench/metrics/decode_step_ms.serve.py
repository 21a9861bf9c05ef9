"""Median wall time of a decode step (ms), host and device together: the
program's ``serve.decode_step`` spans outside the profiled stretch."""
import statistics


def _outside(ctx, r) -> bool:
    tr = ctx.trace
    if tr is None or tr.t_mark is None:
        return True
    return r.t1 <= tr.t_mark - 1.0 or r.t0 >= tr.t_end


def read(ctx):
    xs = [r.t1 - r.t0 for r in ctx.spans
          if r.name == "serve.decode_step" and _outside(ctx, r)]
    return 1e3 * statistics.median(xs) if xs else None
