"""Discrete-event simulation of the paper's server architecture (Fig. 5/21):
g compute groups (conv phase, duration t_conv(k)) feeding one merged-FC
server (serial, duration t_fc). Service times optionally exponential —
assumption (A2) of Theorem 1.

Validates (a) the analytic HE model and (b) the staleness distribution that
justifies implicit momentum = 1 - 1/g.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SimResult:
    time_per_iteration: float
    iterations: int
    mean_staleness: float
    staleness_hist: np.ndarray


def simulate(*, g: int, t_conv: float, t_fc: float, iters: int = 2000,
             exponential: bool = True, seed: int = 0,
             cv: Optional[float] = None, return_trace: bool = False):
    """Event loop: each group cycles (conv compute -> FC service -> update).
    The FC server is serial; groups queue for it. The model version counter
    increments on every FC completion (update); staleness of an update is
    (#updates between the group's model read and its write) (paper §IV-A).

    ``return_trace=True`` additionally returns the per-commit
    ``repro_torch.exec.trace.EventTrace`` (commit group / read version /
    time), the schedule a trace replay executes real SGD along. Recording
    does not touch the RNG stream, so the ``SimResult`` is bit-identical
    either way.
    """
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
        heapq.heappush(events, (dur(t_conv), seq, "conv_done", i))
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
            heapq.heappush(events, (t + dur(t_conv), seq, "conv_done", grp))
            seq += 1

    st = np.asarray(staleness[iters // 10:])  # drop warmup
    result = SimResult(time_per_iteration=done_time / completed,
                       iterations=completed,
                       mean_staleness=float(st.mean()),
                       staleness_hist=np.bincount(st, minlength=2 * g))
    if not return_trace:
        return result
    from repro_torch.exec.trace import EventTrace  # local: core must import alone
    grp_a, rv_a, t_a = (np.asarray(c) for c in zip(*commits))
    return result, EventTrace(num_groups=g, group=grp_a, read_version=rv_a,
                              commit_time=t_a)
