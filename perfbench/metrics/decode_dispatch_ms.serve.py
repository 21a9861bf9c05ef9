"""Median host time a decode step spends enqueueing its launches (ms):
the program's ``serve.decode.dispatch`` spans whose parent is a
``serve.decode_step``, outside the profiled stretch (around
``paged_decode_step`` and the argmax, in ``ContinuousServer._step``)."""
from harness import program_spans as P


def read(ctx):
    return P.median([1e3 * r.duration_s
                        for r in P.named(ctx, "serve.decode.dispatch",
                                         "serve.decode_step")
                        if P.outside(ctx, r)])
