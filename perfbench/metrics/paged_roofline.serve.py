"""Paged decode attention's share of its roofline (%): over the decode
steps of the profiled stretch, each step's B6 work at its live contexts
(every active row's K and V pages read once, at HBM speed, or its FLOPs
at the bf16 rate, the larger) over the device time of the kernels named
below."""
from roofline import counts

PATTERNS = ("paged_decode",)


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.t_mark is None:
        return None
    cfg = ctx.cell.config
    peak = counts.flop_peak(cfg["compute_dtype"])
    fam = counts.of(cfg)
    bound = sum(counts.bound_s(fam.paged_flops(cfg, s["contexts"]),
                               fam.paged_bytes(cfg, s["contexts"]), peak)
                for s in ctx.out["stamps"].steps
                if s["t0"] >= tr.t_mark and s["t1"] <= tr.t_end)
    t = tr.time_of(PATTERNS)
    return 100.0 * bound / t if t > 0 and bound > 0 else None
