"""Median host time of the serving loop's own work a pass (ms): the self
time of the program's ``serve.iteration`` spans outside the profiled
stretch, their duration less their ``serve.prefill`` and
``serve.decode_step`` children (admission, page bookkeeping, slot
updates and retirement), over the passes that ran a decode step."""
from harness import program_spans as P


def read(ctx):
    return P.median(P.self_times_ms(ctx, "serve.iteration",
                                       P.ITERATION_PARTS,
                                       need=("serve.decode_step",)))
