"""Event traces — the contract between the simulators and the execution
engine. A numpy copy of the JAX package's ``repro/exec/trace.py``; in the
port, the serving engine reads request arrival times from it.

An ``EventTrace`` records, for every model update ("commit") of an
asynchronous run, which group committed it, which model version the
group's gradient was read at, and when. The model version counter equals
the commit index, so ``staleness[t] = t - read_version[t]`` — exactly the
quantity the discrete-event simulators (``core.queue_sim``,
``cluster.sim``) predict distributions for, and exactly what
``repro.exec.replay`` needs to *execute* real SGD along the same schedule
(paper §IV-A/§IV-C; Fig. 6's measured-momentum experiments).

Traces come from three places:

- ``queue_sim.simulate(..., return_trace=True)`` — homogeneous groups,
  stochastic service times (Theorem 1's assumption A2 when exponential);
- ``cluster.sim.simulate_hetero(..., return_trace=True)`` — per-group
  service times (stragglers, heterogeneous allocations);
- ``EventTrace.round_robin`` — deterministic schedules that reduce the
  replay engine to the two existing reference implementations
  (``delayed_sgd_run`` and the grouped scan step), used by the
  conformance tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class EventTrace:
    """Commit-ordered record of one asynchronous run.

    ``group[t]``        — id of the group committing update t
    ``read_version[t]`` — model version the gradient of commit t was
                          evaluated at (0 <= read_version[t] <= t)
    ``commit_time[t]``  — simulated wall-clock time of commit t

    The version counter increments by one per commit, so version t is the
    parameter state *after* t commits and ``staleness = t - read_version``.
    """
    num_groups: int
    group: np.ndarray          # (T,) int32
    read_version: np.ndarray   # (T,) int64
    commit_time: np.ndarray    # (T,) float64

    def __post_init__(self):
        object.__setattr__(self, "group",
                           np.asarray(self.group, dtype=np.int32))
        object.__setattr__(self, "read_version",
                           np.asarray(self.read_version, dtype=np.int64))
        object.__setattr__(self, "commit_time",
                           np.asarray(self.commit_time, dtype=np.float64))
        T = self.group.shape[0]
        if self.read_version.shape != (T,) or self.commit_time.shape != (T,):
            raise ValueError("trace arrays must share one leading dim")
        if self.num_groups < 1:
            raise ValueError("need at least one group")
        t = np.arange(T)
        if ((self.read_version < 0) | (self.read_version > t)).any():
            raise ValueError("read_version must satisfy 0 <= rv[t] <= t")
        if T and ((self.group < 0) | (self.group >= self.num_groups)).any():
            raise ValueError("group ids must lie in [0, num_groups)")

    def __len__(self) -> int:
        return int(self.group.shape[0])

    @property
    def staleness(self) -> np.ndarray:
        """Per-commit staleness  t - read_version[t]  (the paper's S)."""
        return np.arange(len(self), dtype=np.int64) - self.read_version

    @property
    def max_staleness(self) -> int:
        return int(self.staleness.max(initial=0))

    def truncate(self, num_commits: int) -> "EventTrace":
        """First ``num_commits`` commits (valid: read_version[t] <= t)."""
        n = min(int(num_commits), len(self))
        return EventTrace(num_groups=self.num_groups, group=self.group[:n],
                          read_version=self.read_version[:n],
                          commit_time=self.commit_time[:n])

    def equal_read_runs(self) -> Optional[int]:
        """Run length L if the trace is exactly partitioned into runs of L
        consecutive commits that all read the run-start version
        (``read_version[t] == (t // L) * L``) — the structure of the
        grouped execution strategy (Fig. 17(b)), which lets the replay
        engine fuse each run with the ``optim.closed_form`` coefficients.
        Returns None for traces without that structure.
        """
        T = len(self)
        if T == 0:
            return None
        nz = np.nonzero(self.read_version)[0]
        L = int(nz[0]) if nz.size else T
        if L == 0 or T % L:
            return None
        expected = (np.arange(T) // L) * L
        return L if np.array_equal(self.read_version, expected) else None

    # -- deterministic constructors -------------------------------------

    @staticmethod
    def round_robin(num_groups: int, num_commits: int,
                    mode: str = "grouped") -> "EventTrace":
        """Deterministic round-robin schedule, group ``t % g`` commits t.

        ``mode="grouped"``: every commit of round r reads the round-start
        version ``r*g`` (staleness 0..g-1 within the round) — the schedule
        ``make_grouped_train_step`` executes.

        ``mode="delayed"``: commit t reads version ``max(0, t - (g-1))`` —
        constant staleness S = g-1 after the cold history, the schedule
        ``delayed_sgd_run(staleness=g-1)`` executes.
        """
        g, T = int(num_groups), int(num_commits)
        if g < 1:
            raise ValueError("need at least one group")
        t = np.arange(T)
        if mode == "grouped":
            rv = (t // g) * g
        elif mode == "delayed":
            rv = np.maximum(0, t - (g - 1))
        else:
            raise ValueError(f"unknown round-robin mode {mode!r}")
        return EventTrace(num_groups=g, group=(t % g).astype(np.int32),
                          read_version=rv,
                          commit_time=(t + 1).astype(np.float64))

    # -- persistence -----------------------------------------------------

    def save(self, path) -> None:
        """Serialize to ``.npz`` (plain arrays, loadable anywhere)."""
        np.savez(path, num_groups=np.int64(self.num_groups),
                 group=self.group, read_version=self.read_version,
                 commit_time=self.commit_time)

    @staticmethod
    def load(path) -> "EventTrace":
        with np.load(path) as z:
            return EventTrace(num_groups=int(z["num_groups"]),
                              group=z["group"],
                              read_version=z["read_version"],
                              commit_time=z["commit_time"])
