"""What every runner of the benchmark shares: where things are, the run's
environment, the files found by name, seeds, the card, and the result line.

A run reads ``BENCHMARK.json`` at the root of its checkout, finds its
cell there by ``--workload``, and loads by name the files that belong to
it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json``; the mix's generator ``traffic/<generator>.py``;
the configuration's family, ``families/<family>.py`` (the program's model
and the seeded weights), ``reference/<family>.py`` (the plain reference)
and ``roofline/<family>.py`` (its counts); and, for each per-layer
metric, the reader ``metrics/<metric>.py``. Nothing about one cell, one
mix or one family is written in the runners.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parents[1]       # perfbench/
REPO = BENCH.parent                                 # the checkout's root
SRC = REPO / "src"                                  # the program under test
CACHE = REPO / "build" / "perfbench"                # fixed, inside the checkout

#: top-level modules that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def clock() -> float:
    """The benchmark's own host clock (seconds)."""
    return time.perf_counter()


def prepare_environment() -> None:
    """Point every cache at a fixed directory inside the checkout, keep
    libraries from loading JAX, and make the program importable. Called
    before anything imports torch."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    for p in (str(SRC), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


# ---------------------------------------------------------------------------
# files found by name
# ---------------------------------------------------------------------------

def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(REPO / "BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        bench = benchmark() if bench is None else bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            known = ", ".join(w["name"] for w in bench["workloads"])
            raise SystemExit(f"unknown workload {name!r}; known: {known}")
        self.entry = found[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config_name = self.entry["config"]
        self.traffic_name = self.entry["traffic"]
        cfg_entry = [c for c in bench["configs"]
                     if c["name"] == self.config_name][0]
        self.config = read_json(REPO / cfg_entry["file"])
        self.traffic = read_json(BENCH / "traffic" / f"{self.traffic_name}.json")
        self.settings = read_json(BENCH / "cells" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.run_seconds = int(bench["run_seconds"])

    @classmethod
    def build(cls, name: str, *, config: dict, traffic: dict, settings: dict,
              chips: int = 1, end_to_end=(), per_layer=(),
              run_seconds: int = 10) -> "Cell":
        """A cell from its parts, outside ``BENCHMARK.json`` (the tests'
        small cells)."""
        cell = cls.__new__(cls)
        cell.entry = {"name": name, "config": config["name"],
                      "traffic": "inline", "chips": chips}
        cell.name, cell.chips = name, chips
        cell.config_name, cell.traffic_name = config["name"], "inline"
        cell.config, cell.traffic, cell.settings = config, traffic, settings
        cell.end_to_end, cell.per_layer = list(end_to_end), list(per_layer)
        cell.run_seconds = run_seconds
        return cell

    @property
    def kind(self) -> str:
        return self.settings["kind"]


def family(config: dict):
    """``families/<family>.py``: the program's model of a configuration."""
    return importlib.import_module(f"families.{config['family']}")


def reference(config: dict):
    """``reference/<family>.py``: the plain reference of a configuration."""
    return importlib.import_module(f"reference.{config['family']}")


def generator(mix: dict):
    """``traffic/<generator>.py``'s ``make(mix, config, seed, seconds,
    device)``: the mix's requests or batches."""
    return importlib.import_module(f"traffic.{mix['generator']}").make


def load_reader(metric: str):
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``'s
    ``read(ctx)``, which returns a number or None (nothing to read)."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------

def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from the run's ``--seed`` (any size) and
    ``tags``, the same on every machine."""
    seq = np.random.SeedSequence([int(seed) % (1 << 64), *map(int, tags)])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, *tags))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def require_cards(n: int) -> None:
    """Exit without a result unless ``n`` CUDA cards are present."""
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is "
              "false); the benchmark measures the card only", file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < n:
        print(f"perfbench: the cell needs {n} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        raise SystemExit(3)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def device_record(count: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(count), "memory_peak_bytes": int(peak_bytes),
            "power_limit": power_limit()}


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

def checks_record(checks: Dict[str, tuple]) -> dict:
    """{name: (value, limit)} -> {name: {"value", "limit"}}."""
    return {k: {"value": float(v), "limit": float(lim)}
            for k, (v, lim) in checks.items()}


def emit(result: dict, checks: Dict[str, tuple]) -> None:
    """Every compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output,
    its ``checks`` key last."""
    for k, (v, lim) in checks.items():
        print(f"check {k} = {float(v)!r} (limit {float(lim)!r})",
              file=sys.stderr)
    line = dict(result)
    line["checks"] = checks_record(checks)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def quantile(xs, q: float) -> float:
    """The ``q`` quantile (0..1), linear between order statistics."""
    xs = np.sort(np.asarray(xs, np.float64))
    if xs.size == 0:
        return float("nan")
    return float(np.quantile(xs, q))
