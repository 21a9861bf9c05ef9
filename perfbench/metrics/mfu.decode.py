"""The whole decode step's share of its roofline (%): each step's
necessary work (every bf16 weight read once and every active row's cache,
at HBM speed, or its FLOPs at the bf16 rate, the larger) over the step's
wall time on the benchmark's clock, summed over the steps outside the
profiled stretch."""
from roofline import counts


def read(ctx):
    tr, cfg = ctx.trace, ctx.cell.config
    peak = counts.flop_peak(cfg["compute_dtype"])
    bound = wall = 0.0
    for s in ctx.out["stamps"].steps:
        if tr is not None and tr.t_mark is not None and \
                s["t1"] > tr.t_mark - 1.0 and s["t0"] < tr.t_end:
            continue
        fl, nb = counts.of(cfg).decode_step_work(cfg, s["contexts"])
        bound += counts.bound_s(fl, nb, peak)
        wall += s["t1"] - s["t0"]
    return 100.0 * bound / wall if wall > 0 else None
