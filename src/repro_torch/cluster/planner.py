"""Time-to-convergence planner over heterogeneous allocations.

The paper's predictive model (§V, App E) picks an execution strategy by
minimizing  total time = HE x SE : seconds/iteration times iterations to
target. This module generalizes the HE half to heterogeneous groups and
composes it with the statistical model:

    T(g, mp, alloc) = HE(g, mp, alloc) * P_SE(g)

The search is 2-D over (g, mp): g async compute groups times mp
model-parallel devices per worker (the engine's "mp" mesh axis,
``engine.spmd``). mp enters the HE half three ways:

- compute: the engine's mp sharding is storage-only — every device of a
  worker runs the full forward/backward on the worker's microbatch — so
  a group's effective data-parallel throughput divides by mp;
- collectives: the data/group gradient exchange carries ``grad_bytes/mp``
  (each device exchanges only its shard), while a new per-worker
  mp-collective gathers the full parameters from the mp shards every
  step (``mp_collective_time``);
- memory: a worker holds ``state_bytes / mp`` per device — the
  feasibility constraint (``mp_feasible``) that makes mp > 1 worth its
  throughput cost for models that do not fit one device
  (``DeviceSpec.mem_bytes``).

P_SE depends on g only: mp changes where bytes live, not the staleness
structure of the update.

- ``group_conv_times``: per-group conv-phase service time from the
  allocation — microbatch / group throughput, overlapped (max) with the
  intra-group collective over the slowest link, mirroring
  ``hardware_model.t_conv``.
- ``hetero_time_per_iteration``: g heterogeneous groups feeding one serial
  merged-FC server. Each group cycles every ``t_i + t_fc`` when the server
  is free, so the aggregate update rate is ``sum_i 1/(t_i + t_fc)`` capped
  by the server rate ``1/t_fc``:

      HE = max( t_fc,  1 / sum_i 1/(t_i + t_fc) )

  With g identical groups this is exactly
  ``hardware_model.he_time_per_iteration``'s
  ``max(t_fc, (t_conv + t_fc)/g)``.
- ``best_allocation``: search over (g, alloc) — ``allocator.allocate`` for
  each candidate g, score by ``HE * predict_se_penalty(g, mu*)``, return
  the best ``Plan``. ``Plan.g`` seeds ``auto_optimizer.algorithm1``
  (its ``plan=`` argument) in place of the homogeneous
  ``smallest_saturating_g`` short-circuit.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

from repro_torch.cluster.allocator import Allocation, allocate
from repro_torch.cluster.devices import DeviceSpec, WorkloadCost
from repro_torch.core.stat_model import predict_se_penalty


@dataclasses.dataclass(frozen=True)
class Plan:
    """One point of the (g, mp, alloc) search, fully scored."""
    g: int
    allocation: Allocation
    group_times: Tuple[float, ...]   # per-group conv service time, seconds
    t_iteration: float               # predicted HE seconds/iteration
    se_penalty: float                # P_SE(g), >= 1
    time_score: float                # t_iteration * se_penalty
    mp: int = 1                      # model-parallel devices per worker

    @property
    def weights(self) -> Tuple[float, ...]:
        return self.allocation.weights

    def describe(self) -> str:
        rows = []
        for i, (idxs, t) in enumerate(zip(self.allocation.groups,
                                          self.group_times)):
            kinds = [self.allocation.devices[j].kind for j in idxs]
            mix = "+".join(f"{kinds.count(k)}{k}" for k in sorted(set(kinds)))
            rows.append(f"  group {i}: {mix:12s} batch="
                        f"{self.allocation.microbatches[i]:4d} "
                        f"t_conv={t * 1e3:.2f}ms")
        return (f"plan g={self.g} mp={self.mp} "
                f"t_iter={self.t_iteration * 1e3:.2f}ms "
                f"P_SE={self.se_penalty:.2f} "
                f"score={self.time_score * 1e3:.2f}ms\n" + "\n".join(rows))


def group_collective_time(devices: Sequence[DeviceSpec],
                          grad_bytes: float) -> float:
    """Ring reduce-scatter + all-gather within a group, paced by the
    slowest link (same form as ``hardware_model.collective_time``)."""
    k = len(devices)
    if k <= 1 or grad_bytes <= 0.0:
        return 0.0
    bw = min(d.net_bw for d in devices)
    return 2.0 * grad_bytes * (k - 1) / k / bw


def mp_collective_time(devices: Sequence[DeviceSpec], param_bytes: float,
                       mp: int) -> float:
    """Per-step all-gather of the full parameters from a worker's mp
    shards, paced by the slowest link: each device receives the other
    shards, ``param_bytes * (mp-1)/mp`` over the worker's slowest link.
    (Momentum is never gathered — the update is elementwise on the local
    shard; the gradient slice back to the shard is local.)"""
    if mp <= 1 or param_bytes <= 0.0 or not devices:
        return 0.0
    bw = min(d.net_bw for d in devices)
    return param_bytes * (mp - 1) / mp / bw


def mp_feasible(devices: Sequence[DeviceSpec],
                cost: Optional[WorkloadCost], mp: int) -> bool:
    """True iff every device can hold its 1/mp shard of the resident
    parameter/optimizer state. Devices without a ``mem_bytes`` capacity
    (or costs without ``state_bytes``) are unconstrained."""
    if cost is None or cost.state_bytes <= 0.0:
        return True
    need = cost.state_bytes / mp
    return all(d.mem_bytes is None or need <= d.mem_bytes for d in devices)


def group_conv_times(alloc: Allocation,
                     cost: Optional[WorkloadCost] = None,
                     mp: int = 1) -> Tuple[float, ...]:
    """Per-group conv-phase time: compute on the group's microbatch,
    overlapped (max) with its intra-group collective. With ``mp > 1``
    the group's effective throughput divides by mp (storage-only model
    parallelism: every device of a worker computes the full microbatch
    gradient), the gradient exchange carries 1/mp of the bytes, and the
    per-worker parameter gather joins the overlap max."""
    times = []
    grad_bytes = cost.grad_bytes if cost is not None else 0.0
    for i in range(alloc.num_groups):
        comp = alloc.microbatches[i] / (alloc.throughputs[i] / mp)
        devs = alloc.group_devices(i)
        coll = group_collective_time(devs, grad_bytes / mp)
        mpc = mp_collective_time(devs, grad_bytes, mp)
        times.append(max(comp, coll, mpc))
    return tuple(times)


def hetero_time_per_iteration(group_times: Sequence[float],
                              t_fc: float) -> float:
    """HE seconds/iteration for heterogeneous groups + one serial FC server."""
    if not group_times:
        raise ValueError("need at least one group")
    rate = sum(1.0 / (t + t_fc) for t in group_times)
    return max(t_fc, 1.0 / rate)


def plan_for_g_mp(devices: Sequence[DeviceSpec], g: int, mp: int, *,
                  global_batch: int, t_fc: float,
                  cost: Optional[WorkloadCost] = None,
                  mu_star_total: float = 0.9, se_sharpness: float = 4.0,
                  se_penalties: Optional[Mapping[int, float]] = None) -> Plan:
    """Score one (g, mp) candidate: allocate, predict HE, multiply by
    P_SE(g). Raises ``ValueError`` when the point is infeasible — a group
    with fewer than mp devices (a worker needs mp shards), or a device
    that cannot hold its 1/mp of the resident state (``mp_feasible``).

    ``se_penalties`` overrides the analytic SE model with *measured*
    penalties (``stat_model.measured_se_from_replay`` over replayed
    traces) for the g values it contains; others fall back to
    ``predict_se_penalty``.
    """
    if mp < 1:
        raise ValueError(f"mp must be >= 1, got {mp}")
    alloc = allocate(devices, g, global_batch, cost=cost)
    for i in range(alloc.num_groups):
        if len(alloc.group_devices(i)) < mp:
            raise ValueError(
                f"(g={g}, mp={mp}) infeasible: group {i} has "
                f"{len(alloc.group_devices(i))} device(s), a worker "
                f"needs {mp}")
    if not mp_feasible(devices, cost, mp):
        raise ValueError(
            f"(g={g}, mp={mp}) infeasible: state_bytes/{mp} = "
            f"{cost.state_bytes / mp:.3g} exceeds a device's mem_bytes")
    times = group_conv_times(alloc, cost, mp)
    t_iter = hetero_time_per_iteration(times, t_fc)
    if se_penalties is not None and g in se_penalties:
        pse = float(se_penalties[g])
    else:
        pse = predict_se_penalty(g, mu_star_total, sharpness=se_sharpness)
    return Plan(g=g, allocation=alloc, group_times=times, t_iteration=t_iter,
                se_penalty=pse, time_score=t_iter * pse, mp=mp)


def plan_for_g(devices: Sequence[DeviceSpec], g: int, *, global_batch: int,
               t_fc: float, cost: Optional[WorkloadCost] = None,
               mu_star_total: float = 0.9, se_sharpness: float = 4.0,
               se_penalties: Optional[Mapping[int, float]] = None) -> Plan:
    """Score one candidate g at mp=1 (``plan_for_g_mp``)."""
    return plan_for_g_mp(devices, g, 1, global_batch=global_batch, t_fc=t_fc,
                         cost=cost, mu_star_total=mu_star_total,
                         se_sharpness=se_sharpness,
                         se_penalties=se_penalties)


def best_allocation(devices: Sequence[DeviceSpec], *, global_batch: int,
                    t_fc: float, cost: Optional[WorkloadCost] = None,
                    mu_star_total: float = 0.9, se_sharpness: float = 4.0,
                    g_candidates: Optional[Sequence[int]] = None,
                    mp_candidates: Optional[Sequence[int]] = None,
                    se_penalties: Optional[Mapping[int, float]] = None
                    ) -> Plan:
    """Search (g, mp, alloc) for the minimum predicted time-to-convergence.

    Default g candidates: every feasible g (1..min(N, global_batch) —
    each group needs a device and at least one example). Default mp
    candidates: (1,) — pure data parallelism, the pre-mp behavior.
    Infeasible (g, mp) points (a group smaller than mp, or a device that
    cannot hold state_bytes/mp — ``plan_for_g_mp``) are skipped; if no
    point is feasible the last infeasibility is re-raised. Returns the
    best ``Plan``; ties break toward smaller g then smaller mp (less
    staleness and less replication for free).

    ``se_penalties`` (measured P_SE per g, from
    ``stat_model.measured_se_from_replay``) replaces the analytic SE
    penalty for the g values it covers — replay-calibrated planning.
    """
    n = len(devices)
    if g_candidates is None:
        g_candidates = range(1, min(n, global_batch) + 1)
    if mp_candidates is None:
        mp_candidates = (1,)
    best: Optional[Plan] = None
    last_err: Optional[ValueError] = None
    for g in g_candidates:
        if not 1 <= g <= min(n, global_batch):
            raise ValueError(f"candidate g={g} infeasible for N={n}, "
                             f"batch={global_batch}")
        for mp in mp_candidates:
            try:
                plan = plan_for_g_mp(devices, g, mp,
                                     global_batch=global_batch, t_fc=t_fc,
                                     cost=cost, mu_star_total=mu_star_total,
                                     se_sharpness=se_sharpness,
                                     se_penalties=se_penalties)
            except ValueError as e:
                last_err = e
                continue
            if best is None or plan.time_score < best.time_score:
                best = plan
    if best is None:
        raise ValueError(
            f"no feasible (g, mp) point over g={list(g_candidates)!r}, "
            f"mp={list(mp_candidates)!r}") from last_err
    return best
