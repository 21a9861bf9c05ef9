"""Flash prefill attention's share of its roofline (%): over the
prefills of the profiled stretch, B5's work at each prefill's shape
(slots x bucket causal rows, every layer; its FLOPs at the bf16 rate or
its q, k, v and output bytes at HBM speed, the larger) over the device
time of the kernels named below."""
from roofline import counts

PATTERNS = ("flash_fwd",)


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.t_mark is None:
        return None
    cfg = ctx.cell.config
    peak = counts.flop_peak(cfg["compute_dtype"])
    bound = 0.0
    for p in ctx.out["stamps"].prefills:
        if p["t0"] >= tr.t_mark and p["t1"] <= tr.t_end:
            fl, nb = counts.of(cfg).flash_work(cfg, p["rows"], p["bucket"])
            bound += counts.bound_s(fl, nb, peak)
    t = tr.time_of(PATTERNS)
    return 100.0 * bound / t if t > 0 and bound > 0 else None
