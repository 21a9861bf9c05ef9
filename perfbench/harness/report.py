"""One run of a cell: drive it, judge it, read its metrics, build the line."""
from __future__ import annotations

import dataclasses
import importlib
import math
import sys
from typing import Dict, Optional

import torch

from harness import common


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""
    cell: object
    out: Dict
    trace: object            # harness.trace.DeviceTrace or None
    spans: tuple             # the program's span records, traced runs only
    world: int = 1


def make_runner(cell, seed: int, seconds: float, trace: bool, *,
                device: str = "cuda", rank: int = 0, world: int = 1,
                t_start: Optional[float] = None):
    """The runner of the cell's ``kind``: ``harness/<kind>.py``'s ``Run``."""
    t_start = common.clock() if t_start is None else t_start
    try:
        mod = importlib.import_module(f"harness.{cell.kind}")
    except ModuleNotFoundError:
        raise SystemExit(f"unknown cell kind {cell.kind!r}")
    return mod.Run(cell, seed, seconds, trace,
                   mod.Options(device=device, rank=rank, world=world),
                   t_start)


def checks_of(cell, numbers: Dict[str, float]) -> Dict[str, tuple]:
    limits = cell.settings["limits"]
    return {k: (numbers[k], float(limits[k])) for k in limits}


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", rank: int = 0, world: int = 1,
             t_start: Optional[float] = None):
    """-> (result line without checks, checks) on rank 0; (None, None) on
    the other ranks."""
    drv = make_runner(cell, seed, seconds, trace, device=device, rank=rank,
                      world=world, t_start=t_start)
    out = drv.run()
    dtrace = out.get("trace")
    busy = (dtrace.busy_s, dtrace.window_s) if dtrace is not None else None
    peaks, busies = [out["peak"]], [busy]
    if world > 1:
        import torch.distributed as dist
        gathered = [None] * world
        dist.all_gather_object(gathered, (out["peak"], busy))
        peaks = [g[0] for g in gathered]
        busies = [g[1] for g in gathered]
        if rank != 0:
            return None, None
    if out.get("note"):
        print(out["note"], file=sys.stderr)
    numbers = drv.judge(out)
    checks = checks_of(cell, numbers)
    finite = all(math.isfinite(v) for v, _ in checks.values())
    correct = bool(finite and out.get("failed", 0) == 0
                   and out.get("finite", True)
                   and all(v <= lim for v, lim in checks.values()))
    device_rec = (common.device_record(world, max(peaks))
                  if torch.device(device).type == "cuda" else
                  {"platform": "cpu", "kind": "cpu", "count": 1,
                   "memory_peak_bytes": 0})
    line = {"correct": correct,
            "attempted": int(out.get("attempted", out.get("rounds", 0))),
            "failed": int(out.get("failed", 0))}
    if not trace:
        values = out["end_to_end"]
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    else:
        ctx = Context(cell=cell, out=out, trace=dtrace,
                      spans=(out["tracer"].records()
                             if out.get("tracer") is not None else ()),
                      world=world)
        metrics = {}
        for m in cell.per_layer:
            value = common.load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        got = [b for b in busies if b is not None]
        if got:
            device_rec["busy_s"] = sum(b for b, _ in got) / len(got)
            device_rec["window_s"] = sum(w for _, w in got) / len(got)
    line["metrics"] = metrics
    line["device"] = device_rec
    if trace and dtrace is not None:
        s = dtrace.summary()
        line["breakdown"] = s["breakdown"]
    return line, checks
