"""Heterogeneous discrete-event simulation of the server architecture.

Generalizes ``core.queue_sim.simulate`` (g identical compute groups feeding
one serial merged-FC server) to *per-group* conv service times, so
staleness and time-per-iteration can be validated under heterogeneous
allocations and stragglers: group i's conv phase has mean ``t_conv[i]``
(its microbatch / group throughput, see ``cluster.planner``), optionally
scaled by a per-group straggler factor.

The event loop and RNG consumption order mirror ``queue_sim.simulate``
statement-for-statement, so with identical group means (and the same seed)
the result is bit-identical to the homogeneous simulator — the reduction
property the tier-1 tests pin down.
"""
from __future__ import annotations

import heapq
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.queue_sim import SimResult


def simulate_hetero(*, t_conv: Sequence[float], t_fc: float,
                    iters: int = 2000, exponential: bool = True,
                    seed: int = 0, cv: Optional[float] = None,
                    slowdown: Optional[Sequence[float]] = None,
                    return_trace: bool = False):
    """Event loop with per-group conv means ``t_conv`` (length g).

    ``slowdown``, when given, multiplies each group's mean — a straggler
    model (e.g. ``[1, 1, 3, 1]`` makes group 2 a 3x straggler). Staleness
    of an update is the number of model updates between the group's read
    and its write, exactly as in the homogeneous simulator.

    ``return_trace=True`` additionally returns the per-commit
    ``repro_torch.exec.trace.EventTrace`` for a trace replay; recording
    does not consume RNG, so the ``SimResult`` is bit-identical either
    way.
    """
    t_conv = [float(t) for t in t_conv]
    g = len(t_conv)
    if g < 1:
        raise ValueError("need at least one group")
    if slowdown is not None:
        if len(slowdown) != g:
            raise ValueError(f"slowdown needs length g={g}")
        t_conv = [t * float(s) for t, s in zip(t_conv, slowdown)]
    rng = np.random.default_rng(seed)

    def dur(mean):
        if exponential:
            return rng.exponential(mean)
        if cv:  # lognormal with given coefficient of variation
            sigma = np.sqrt(np.log(1 + cv ** 2))
            return rng.lognormal(np.log(mean) - sigma ** 2 / 2, sigma)
        return mean

    version = 0
    read_version = {i: 0 for i in range(g)}
    staleness = []
    commits = []  # (group, read_version, time) per fc_done
    fc_busy_until = 0.0
    done_time = None
    events = []  # (time, seq, kind, group)
    seq = 0
    for i in range(g):
        heapq.heappush(events, (dur(t_conv[i]), seq, "conv_done", i))
        seq += 1

    completed = 0
    while completed < iters and events:
        t, _, kind, grp = heapq.heappop(events)
        if kind == "conv_done":
            start = max(t, fc_busy_until)
            fin = start + dur(t_fc)
            fc_busy_until = fin
            heapq.heappush(events, (fin, seq, "fc_done", grp))
            seq += 1
        else:  # fc_done: model update commits
            staleness.append(version - read_version[grp])
            commits.append((grp, read_version[grp], t))
            version += 1
            completed += 1
            done_time = t
            read_version[grp] = version     # group re-reads fresh model
            heapq.heappush(events, (t + dur(t_conv[grp]), seq, "conv_done", grp))
            seq += 1

    st = np.asarray(staleness[iters // 10:])  # drop warmup
    result = SimResult(time_per_iteration=done_time / completed,
                       iterations=completed,
                       mean_staleness=float(st.mean()),
                       staleness_hist=np.bincount(st, minlength=2 * g))
    if not return_trace:
        return result
    from repro_torch.exec.trace import EventTrace  # local: avoids import cycles
    grp_a, rv_a, t_a = (np.asarray(c) for c in zip(*commits))
    return result, EventTrace(num_groups=g, group=grp_a, read_version=rv_a,
                              commit_time=t_a)
