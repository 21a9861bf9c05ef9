"""Black-box device profiles — the heterogeneity premise of paper §V.

The paper's predictive model treats every node as a *black box* with a
measured throughput: the optimizer never inspects what the device is, only
how many examples per second it pushes through the actual training step.
This module provides both halves of that premise:

- ``DeviceSpec``: a named roofline profile (CPU / GPU / TPU) that can
  *predict* throughput for a workload cost when no measurement exists
  (planning before the cluster is up), and
- ``profile_device``: the black-box probe that *measures* the training
  step on the device actually running, returning a spec whose
  ``throughput`` field overrides the roofline.

Specs are consumed by ``cluster.allocator`` (group packing + batch shares)
and ``cluster.planner`` (time-to-convergence search). The JAX package's
``cluster/devices.py``: the registry and the parsing are copies (every
``--cluster-spec`` the JAX launcher accepts parses here), plus a
``gpu-h100-sxm`` entry; the probe synchronizes CUDA where the JAX one
blocks on its result.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.hardware_model import H100


@dataclasses.dataclass(frozen=True)
class WorkloadCost:
    """Per-example cost of one training step + the collective payload."""
    flops_per_example: float     # fwd+bwd FLOPs for ONE example
    bytes_per_example: float     # HBM/DRAM traffic for ONE example
    grad_bytes: float = 0.0      # gradient payload reduced within a group
    state_bytes: float = 0.0     # resident params+optimizer bytes per model
    #                              replica (the mp axis shards this: a worker
    #                              of mp devices holds state_bytes/mp each)


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One device, roofline profile + optional black-box measurement.

    ``throughput`` (examples/s), when set, is a *measurement* and takes
    precedence over the roofline prediction — the paper's "each node is a
    black box" contract.
    """
    name: str
    kind: str                    # "cpu" | "gpu" | "tpu"
    peak_flops: float            # FLOP/s
    mem_bw: float                # bytes/s
    net_bw: float                # bytes/s to the reduction / parameter server
    throughput: Optional[float] = None   # measured examples/s (black box)
    mem_bytes: Optional[float] = None    # device memory capacity; None =
    #                                      unconstrained (planner memory-
    #                                      feasibility checks skip it)

    def predict_throughput(self, cost: Optional[WorkloadCost] = None) -> float:
        """Examples/s: the measurement if present, else the roofline."""
        if self.throughput is not None:
            return self.throughput
        if cost is None:
            raise ValueError(
                f"device {self.name!r} has no measured throughput; "
                "pass a WorkloadCost for the roofline prediction")
        t = max(cost.flops_per_example / self.peak_flops,
                cost.bytes_per_example / self.mem_bw)
        if t <= 0.0:
            raise ValueError("WorkloadCost must be positive")
        return 1.0 / t


# ---------------------------------------------------------------------------
# Registry. Constants: EC2 c4/g2 are the paper's CPU/GPU cluster nodes
# (§VI-A); titan-x its workstation GPU; gpu-h100-sxm mirrors
# core.hardware_model.H100 so the homogeneous model and this subsystem
# agree. The JAX package's accelerator entry stays, under its name and
# figures, so that the specs its launcher accepts plan the same here.
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, DeviceSpec] = {}


def register_device(spec: DeviceSpec) -> DeviceSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_device(name: str) -> DeviceSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown device {name!r}; known: {sorted(_REGISTRY)}") from None


def list_devices() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_device(DeviceSpec("cpu-c4.4xlarge", "cpu",
                           peak_flops=0.45e12, mem_bw=60e9, net_bw=1.25e9,
                           mem_bytes=30e9))
register_device(DeviceSpec("gpu-g2.2xlarge", "gpu",
                           peak_flops=2.4e12, mem_bw=160e9, net_bw=1.25e9,
                           mem_bytes=4e9))
register_device(DeviceSpec("gpu-titan-x", "gpu",
                           peak_flops=6.6e12, mem_bw=336e9, net_bw=1.25e9,
                           mem_bytes=12e9))
register_device(DeviceSpec("tpu-v5e", "tpu",
                           peak_flops=197e12, mem_bw=819e9, net_bw=50e9,
                           mem_bytes=16e9))
register_device(DeviceSpec(H100.name, "gpu", peak_flops=H100.peak_flops,
                           mem_bw=H100.hbm_bw, net_bw=H100.link_bw,
                           mem_bytes=80e9))


_SPEC_ITEM = re.compile(r"^(?:(\d+)x)?([A-Za-z0-9_.\-]+)$")


def parse_cluster_spec(spec: str) -> Tuple[DeviceSpec, ...]:
    """Parse ``"8xgpu-g2.2xlarge,8xcpu-c4.4xlarge"`` into device instances."""
    devices = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        m = _SPEC_ITEM.match(item)
        if not m:
            raise ValueError(f"bad cluster-spec item {item!r} "
                             "(expected [<count>x]<device-name>)")
        count = int(m.group(1) or 1)
        if count < 1:
            raise ValueError(f"bad device count in {item!r}")
        devices.extend([get_device(m.group(2))] * count)
    if not devices:
        raise ValueError(f"empty cluster spec {spec!r}")
    return tuple(devices)


# ---------------------------------------------------------------------------
# Black-box probe
# ---------------------------------------------------------------------------

def profile_device(step_fn: Callable, args: Sequence, *, batch_size: int,
                   warmup: int = 1, iters: int = 5, device="cuda") -> float:
    """Time the actual training step and return examples/s.

    ``step_fn(*args)`` is run ``warmup`` untimed calls (absorbing kernel
    builds and allocator growth) then ``iters`` timed calls on the host
    clock; the median wall time is the black-box service time. CUDA work
    is asynchronous, so on a ``cuda`` device every timer read comes after
    ``torch.cuda.synchronize(device)``: the clock reads finished work, not
    its enqueue. The probe never looks inside the step — that is the
    point. Its span carries the torch/CUDA versions and the device name
    (``obs.meta.run_metadata``).
    """
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    import torch

    from repro_torch.device import resolve
    from repro_torch.obs import spans
    from repro_torch.obs.meta import run_metadata
    device = resolve(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    meta = run_metadata(device)
    with spans.span("cluster.profile_device", batch_size=batch_size,
                    warmup=warmup, iters=iters, torch=meta["torch"],
                    cuda=meta["cuda"], device=meta["device_kind"]) as sp:
        for _ in range(warmup):
            step_fn(*args)
        times = []
        for _ in range(iters):
            sync()
            t0 = time.perf_counter()
            step_fn(*args)
            sync()
            times.append(time.perf_counter() - t0)
        times.sort()
        median = times[len(times) // 2]
        thr = batch_size / median
        sp.set(examples_per_s=thr)
    return thr


def profiled_spec(spec: DeviceSpec, step_fn: Callable, args: Sequence, *,
                  batch_size: int, warmup: int = 1, iters: int = 5,
                  device="cuda") -> DeviceSpec:
    """Return ``spec`` with its black-box ``throughput`` field measured."""
    thr = profile_device(step_fn, args, batch_size=batch_size,
                         warmup=warmup, iters=iters, device=device)
    return dataclasses.replace(spec, throughput=thr)


def spec_from_telemetry(spec: DeviceSpec, telemetry, *, batch_size: int,
                        window: Optional[int] = None) -> DeviceSpec:
    """``spec`` with throughput taken from an execution engine's per-step
    telemetry (``repro_torch.engine.timing.Telemetry``) — the
    planner-calibration path that needs no extra probe run: the training
    steps the engine already timed ARE the black-box measurement.
    ``window`` calibrates from only the most recent N steady steps
    (time-varying clusters — the online ``rebalance()`` hook; see also
    ``Telemetry.drift``)."""
    return dataclasses.replace(
        spec, throughput=telemetry.throughput(batch_size, window=window))
