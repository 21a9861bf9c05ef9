"""Share of the profiled stretch of serving (%) in which the device was
idle while the host enqueued a decode step: the device-idle time that
overlaps the program's ``serve.decode.dispatch`` spans under a
``serve.decode_step``, mapped onto the trace's clock
(``harness.span_clock``), over the stretch's length. A part of
``idle_share.serve``."""
from harness import program_spans as P


def read(ctx):
    return P.idle_share(ctx, "serve.decode.dispatch", "serve.decode_step")
