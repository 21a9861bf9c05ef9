"""Heterogeneous cluster subsystem (paper §V's third contribution).

Black-box device profiles (``devices``), throughput-proportional group
allocation (``allocator``), heterogeneous queue simulation (``sim``),
the time-to-convergence planner ``T(g, alloc) = HE x SE`` (``planner``),
and the serving-mode planner splitting devices into prefill vs decode
pools against a latency SLO (``serving``).
"""
from repro_torch.cluster.allocator import Allocation, allocate, rebalance
from repro_torch.cluster.devices import (DeviceSpec, WorkloadCost, get_device,
                                   list_devices, parse_cluster_spec,
                                   profile_device, profiled_spec,
                                   register_device, spec_from_telemetry)
from repro_torch.cluster.planner import (Plan, best_allocation,
                                   hetero_time_per_iteration,
                                   mp_collective_time, mp_feasible,
                                   plan_for_g, plan_for_g_mp)
from repro_torch.cluster.serving import (ServingPlan, ServingSimResult,
                                   plan_serving, simulate_serving, tok_rate)
from repro_torch.cluster.sim import simulate_hetero

__all__ = [
    "Allocation", "allocate", "rebalance",
    "DeviceSpec", "WorkloadCost", "get_device", "list_devices",
    "parse_cluster_spec", "profile_device", "profiled_spec",
    "register_device", "spec_from_telemetry",
    "Plan", "best_allocation", "hetero_time_per_iteration",
    "mp_collective_time", "mp_feasible", "plan_for_g", "plan_for_g_mp",
    "ServingPlan", "ServingSimResult", "plan_serving", "simulate_serving",
    "tok_rate",
    "simulate_hetero",
]
