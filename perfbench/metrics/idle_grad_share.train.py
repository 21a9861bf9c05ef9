"""Share of the profiled rounds (%) in which the device was idle while a
group's forward and backward ran on the host: the device-idle time that
overlaps the program's ``round.grad`` spans, mapped onto the trace's
clock (``harness.span_clock``), over the stretch's length. A part of
``idle_share.train``."""
from harness import program_spans as P


def read(ctx):
    return P.idle_share(ctx, "round.grad")
