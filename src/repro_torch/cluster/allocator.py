"""Heterogeneous group allocation + throughput-proportional batch shares.

Partitions N black-box devices (``cluster.devices.DeviceSpec``) into g
compute groups and apportions the global batch across groups in proportion
to group throughput, so every group's conv phase finishes at (predicted)
the same time — the load-balancing idea of OmniLearn (PAPERS.md) applied to
Omnivore's group axis.

- ``allocate``: LPT-style greedy packing — devices sorted by descending
  throughput, each placed in the currently slowest group — which both
  guarantees no empty group (g <= N) and near-equalizes group throughputs.
- ``rebalance``: measurement-driven correction — given observed per-group
  step times, re-estimates group throughputs as share/time and re-apportions
  the batch so predicted per-group step times equalize (OmniLearn's dynamic
  batch sizing).

The resulting integer ``microbatches`` are consumable by
``compute_groups.group_batch_split(batch, g, sizes=...)`` and the
``weights`` by ``async_sgd.make_grouped_train_step(group_weights=...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.cluster.devices import DeviceSpec, WorkloadCost


@dataclasses.dataclass(frozen=True)
class Allocation:
    """g groups over a fixed device tuple + the batch apportionment."""
    devices: Tuple[DeviceSpec, ...]
    groups: Tuple[Tuple[int, ...], ...]     # device indices per group
    throughputs: Tuple[float, ...]          # examples/s per group
    microbatches: Tuple[int, ...]           # per-group batch share, sums to B
    global_batch: int

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def weights(self) -> Tuple[float, ...]:
        """Gradient-averaging weights: the batch share of each group."""
        return tuple(b / self.global_batch for b in self.microbatches)

    def group_devices(self, i: int) -> Tuple[DeviceSpec, ...]:
        return tuple(self.devices[j] for j in self.groups[i])


def _apportion(total: int, weights: Sequence[float], minimum: int = 1
               ) -> Tuple[int, ...]:
    """Largest-remainder apportionment of ``total`` ∝ ``weights``, each
    share >= ``minimum``."""
    n = len(weights)
    if total < n * minimum:
        raise ValueError(f"batch {total} too small for {n} groups "
                         f"(minimum {minimum} each)")
    wsum = float(sum(weights))
    if wsum <= 0.0:
        raise ValueError("weights must have positive sum")
    spare = total - n * minimum
    ideal = [spare * w / wsum for w in weights]
    shares = [int(x) for x in ideal]
    rem = spare - sum(shares)
    # hand the remaining units to the largest fractional parts
    order = sorted(range(n), key=lambda i: ideal[i] - shares[i], reverse=True)
    for i in order[:rem]:
        shares[i] += 1
    return tuple(minimum + s for s in shares)


def allocate(devices: Sequence[DeviceSpec], g: int, global_batch: int, *,
             cost: Optional[WorkloadCost] = None) -> Allocation:
    """Pack ``devices`` into ``g`` groups (LPT greedy) and split the batch
    proportional to group throughput."""
    n = len(devices)
    if not 1 <= g <= n:
        raise ValueError(f"g={g} must be in 1..N={n}")
    thr = [d.predict_throughput(cost) for d in devices]
    order = sorted(range(n), key=lambda i: thr[i], reverse=True)
    groups = [[] for _ in range(g)]
    gthr = [0.0] * g
    for i in order:
        # LPT: place the next-fastest device in the slowest group; the first
        # g placements seed every group, so none is ever empty
        j = min(range(g), key=lambda k: (gthr[k], len(groups[k])))
        groups[j].append(i)
        gthr[j] += thr[i]
    micro = _apportion(global_batch, gthr)
    return Allocation(devices=tuple(devices),
                      groups=tuple(tuple(gr) for gr in groups),
                      throughputs=tuple(gthr),
                      microbatches=micro,
                      global_batch=global_batch)


def rebalance(alloc: Allocation, measured_step_times: Sequence[float]
              ) -> Allocation:
    """Re-apportion the batch from *observed* per-group step times.

    The black-box group throughput becomes share/time; re-running the
    proportional apportionment then equalizes predicted step times — the
    fixed point is reached when every group takes the same wall time per
    round (OmniLearn's balance condition).
    """
    if len(measured_step_times) != alloc.num_groups:
        raise ValueError(f"need {alloc.num_groups} measured times, got "
                         f"{len(measured_step_times)}")
    if any(t <= 0.0 for t in measured_step_times):
        raise ValueError("measured step times must be positive")
    new_thr = tuple(b / t for b, t in zip(alloc.microbatches,
                                          measured_step_times))
    micro = _apportion(alloc.global_batch, new_thr)
    return dataclasses.replace(alloc, throughputs=new_thr,
                               microbatches=micro)
