"""Median time a decode step waits for its token (ms): the self time of
the program's ``serve.decode_step`` spans outside the profiled stretch,
their duration less their ``serve.decode.upload`` and
``serve.decode.dispatch`` children. It holds the benchmark's own stamps
of the step (its reads of the positions and the active mask, and the
synchronize after the step)."""
from harness import program_spans as P


def read(ctx):
    return P.median(P.self_times_ms(ctx, "serve.decode_step",
                                       P.DECODE_PARTS, need=P.DECODE_PARTS))
