"""Prefill's share of the card's bf16 peak (%): the forward FLOPs the
admitted prompts need (their own tokens only) over the prefills' wall
time on the benchmark's clock times the peak, outside the profiled
stretch. The rows a prefill computes beyond its prompts are waste and do
not count."""
from roofline import counts


def read(ctx):
    tr, cfg = ctx.trace, ctx.cell.config
    flops = wall = 0.0
    for p in ctx.out["stamps"].prefills:
        if tr is not None and tr.t_mark is not None and \
                p["t1"] > tr.t_mark - 1.0 and p["t0"] < tr.t_end:
            continue
        flops += counts.of(cfg).forward_flops(cfg, p["plens"])
        wall += p["t1"] - p["t0"]
    if wall <= 0:
        return None
    return 100.0 * flops / (wall * counts.flop_peak(cfg["compute_dtype"]))
