"""Mean share of the experts that a decode step's live rows route to in a
layer (%): the program's ``serve.moe_experts`` instant, which the server
records once after the window from its device counters (the distinct
experts the live rows chose, summed over the steps with a live row and
the MoE layers), over experts x layers x steps. The counters cover every
decode step of the window; the program records none of it where it has
no dropless MoE, and the reader then returns None."""
from harness import program_spans as P


def read(ctx):
    found = P.named(ctx, "serve.moe_experts")
    if not found:
        return None
    a = found[-1].attrs
    n = a["experts"] * a["layers"] * a["steps"]
    return 100.0 * a["live_experts"] / n if n else None
