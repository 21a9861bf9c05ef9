"""Post-run HE x SE decomposition — the planner's prediction, measured.

The planner (``cluster.planner``) predicts time-to-convergence as
``T(g, alloc) = HE * P_SE``: seconds per *commit* (one group's model
update) times the statistical-efficiency penalty. A live run measures
the other side of that equation: the engine's metric stream records
wall seconds per *round* (all g groups commit once per grouped step), so

    HE_measured = median steady step_s / g

``hexse_report`` recomputes ``T`` from a run's own metrics and diffs it
against the plan — closing the predict->measure loop the paper's
optimizer rests on, and the drift signal an online ``rebalance()``
consumes. ``calibrated_plan`` builds the fair-comparison
plan: DeviceSpecs whose throughput comes from the very metrics stream
under test (``cluster.spec_from_telemetry``'s contract, generalized to a
windowed stream), so prediction error isolates the queueing model rather
than roofline guesswork.

Also usable from the shell on a metrics sink file::

    python -m repro_torch.obs.report metrics.jsonl --groups 2 --batch 64

A copy of the JAX package's ``obs/report.py`` over the port's
``obs.metrics`` and ``engine.timing``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


def _steady(series, skip: int = 1):
    vals = series.values if hasattr(series, "values") else list(series)
    return vals[skip:] if len(vals) > skip else list(vals)


def measured_step_stats(metrics, skip: int = 1):
    """min/median/IQR ``TimeStats`` of the steady step_s stream (the same
    estimator the bench emitters use — ``engine.timing.stats_of``)."""
    from repro_torch.engine.timing import stats_of
    series = metrics.series("step_s") if hasattr(metrics, "series") \
        else metrics
    steady = _steady(series, skip)
    if not steady:
        raise ValueError("metrics stream has no steady step_s samples")
    return stats_of(steady)


@dataclasses.dataclass(frozen=True)
class HexSeReport:
    """Measured-vs-predicted decomposition of one run against one plan."""
    g: int
    steps: int                       # steady steps measured
    he_measured_s: float             # measured seconds per commit
    he_predicted_s: float            # plan.t_iteration
    se_penalty: float                # plan's P_SE(g)
    t_measured_s: float              # HE_measured * P_SE
    t_predicted_s: float             # plan.time_score
    data_wait_frac: float            # host-side wait / (wait + step)
    he_rel_err: float                # |measured - predicted| / predicted

    def within(self, tol: float) -> bool:
        return self.he_rel_err <= tol

    def render(self) -> str:
        return (
            f"HE x SE decomposition (g={self.g}, {self.steps} steady "
            f"steps)\n"
            f"  HE   measured {self.he_measured_s * 1e3:9.3f} ms/commit"
            f"   predicted {self.he_predicted_s * 1e3:9.3f} ms/commit"
            f"   err {self.he_rel_err:.1%}\n"
            f"  P_SE {self.se_penalty:9.3f}\n"
            f"  T    measured {self.t_measured_s * 1e3:9.3f} ms"
            f"           predicted {self.t_predicted_s * 1e3:9.3f} ms\n"
            f"  host data wait: {self.data_wait_frac:.1%} of the loop")


def hexse_report(metrics, plan, *, skip: int = 1) -> HexSeReport:
    """Recompute ``T(g, alloc)`` from a run's metric stream (or a
    ``Telemetry`` facade — both expose ``series``/``registry``) and diff
    it against ``plan``'s prediction (module doc)."""
    reg = getattr(metrics, "registry", metrics)
    stats = measured_step_stats(reg, skip=skip)
    he_measured = stats.median_s / plan.g
    waits = _steady(reg.series("data_wait_s"), skip)
    steps = _steady(reg.series("step_s"), skip)
    tot_wait, tot_step = sum(waits), sum(steps)
    wait_frac = tot_wait / (tot_wait + tot_step) if tot_step > 0 else 0.0
    return HexSeReport(
        g=plan.g, steps=stats.iters,
        he_measured_s=he_measured, he_predicted_s=plan.t_iteration,
        se_penalty=plan.se_penalty,
        t_measured_s=he_measured * plan.se_penalty,
        t_predicted_s=plan.time_score,
        data_wait_frac=wait_frac,
        he_rel_err=abs(he_measured - plan.t_iteration)
        / plan.t_iteration)


def calibrated_plan(metrics, *, g: int, global_batch: int,
                    devices_per_group: int = 1, t_fc: float = 1e-6,
                    skip: int = 1, window: Optional[int] = None,
                    kind: str = "cpu"):
    """A ``Plan`` whose device throughputs are calibrated from the run's
    own metrics stream — the richer-stream successor of
    ``cluster.spec_from_telemetry``.

    The engine's g groups execute one *round* per step concurrently, so a
    group's service time is the round wall time and its throughput is
    ``(global_batch / g) / step_s``; each of the group's
    ``devices_per_group`` device slots carries an equal share. ``window``
    keeps only the last N steady steps (time-varying recalibration — the
    OmniLearn drift hook).
    """
    from repro_torch.cluster.devices import DeviceSpec
    from repro_torch.cluster.planner import plan_for_g
    reg = getattr(metrics, "registry", metrics)
    steady = _steady(reg.series("step_s"), skip)
    if window is not None:
        steady = steady[-int(window):]
    if not steady:
        raise ValueError("no steady step_s samples to calibrate from")
    from repro_torch.engine.timing import stats_of
    step_s = stats_of(steady).median_s
    per_device = (global_batch / g) / step_s / devices_per_group
    spec = DeviceSpec("calibrated", kind, peak_flops=1.0, mem_bw=1.0,
                      net_bw=1e12, throughput=per_device)
    return plan_for_g([spec] * (g * devices_per_group), g,
                      global_batch=global_batch, t_fc=t_fc)


def summarize(registry, run: Optional[dict] = None,
              skip: int = 1) -> Tuple[str, ...]:
    """Human-readable lines for a metrics stream without a plan (the CLI
    path: everything the sink file alone supports)."""
    from repro_torch.engine.timing import stats_of
    lines = []
    if run:
        lines.append("run: " + ", ".join(f"{k}={v}" for k, v in
                                         sorted(run.items())))
    for name in registry.names():
        m = registry.get(name)
        if hasattr(m, "values") and m.values:
            s = stats_of(_steady(m, skip))
            lines.append(f"series {name}: n={len(m)} min={s.min_s:.6g} "
                         f"median={s.median_s:.6g} iqr={s.iqr_s:.6g}")
        elif hasattr(m, "value") and m.value is not None:
            lines.append(f"{type(m).__name__.lower()} {name}: {m.value}")
    for msg in registry.notes:
        lines.append(f"note: {msg}")
    return tuple(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    from repro_torch.obs.metrics import MetricRegistry
    ap = argparse.ArgumentParser(
        description="summarize a metrics JSONL sink; with --groups and "
                    "--batch, run the HE x SE decomposition against a "
                    "plan calibrated from the stream itself")
    ap.add_argument("metrics", help="metrics .jsonl file")
    ap.add_argument("--skip", type=int, default=1,
                    help="leading (compile) steps to drop (default 1)")
    ap.add_argument("--groups", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--window", type=int, default=0,
                    help="calibrate from only the last N steady steps")
    args = ap.parse_args(argv)
    reg, run = MetricRegistry.from_jsonl(args.metrics)
    for line in summarize(reg, run, skip=args.skip):
        print(line)
    if args.groups and args.batch:
        plan = calibrated_plan(reg, g=args.groups,
                               global_batch=args.batch, skip=args.skip,
                               window=args.window or None)
        print(hexse_report(reg, plan, skip=args.skip).render())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
