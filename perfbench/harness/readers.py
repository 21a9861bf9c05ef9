"""What the training cells' per-layer metrics read; each metric's file
under ``metrics/`` names one of these."""
from __future__ import annotations

from harness.trace import idle_share as _idle_share
from roofline import counts

UPDATE_KERNELS = ("fused_update",)


def data_wait_ms(ctx):
    """Mean ``engine.data_wait`` span over the unprofiled rounds (ms)."""
    lo, hi, _ = ctx.out["clean"]
    xs = [r.t1 - r.t0 for r in ctx.spans
          if r.name == "engine.data_wait" and r.t0 >= lo and r.t1 <= hi]
    return 1e3 * sum(xs) / len(xs) if xs else None


def idle_share(ctx):
    return _idle_share(ctx.trace)


def mfu(ctx):
    """Necessary FLOPs a round over the unprofiled round time times the
    peak of every card the round uses (%)."""
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    lo, hi, rounds = ctx.out["clean"]
    if rounds < 1 or hi <= lo:
        return None
    flops = counts.of(cfg).train_round_flops(cfg, mix)
    peak = counts.flop_peak(cfg["compute_dtype"]) * ctx.world
    return 100.0 * flops / ((hi - lo) / rounds) / peak


def update_roofline(ctx):
    """B1's bytes a round at HBM speed over its device time (%)."""
    tr, rounds = ctx.trace, ctx.out["traced"]
    if tr is None or rounds < 1:
        return None
    t = tr.time_of(UPDATE_KERNELS) / rounds
    if t <= 0:
        return None
    cfg = ctx.cell.config
    nbytes = counts.update_bytes(counts.of(cfg).params(cfg),
                                 int(ctx.cell.settings["groups"]))
    return 100.0 * (nbytes / counts.peak("hbm_bytes_s")) / t
