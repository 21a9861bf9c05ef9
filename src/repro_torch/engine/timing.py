"""Monotonic timing: the port's one wall clock, its measurement probe and
per-step telemetry.

``monotonic()`` is ``time.perf_counter`` as in the JAX package's
``engine/timing.py``. ``probe`` times a callable on that clock; CUDA work
is asynchronous, so every timed call ends in ``torch.cuda.synchronize``
whenever CUDA is in use, and the clock reads the finished work, not its
enqueue. (Kernel times on the card come from CUDA events in
``chip_smoke.py``; ``probe`` is the host-clock view of a whole call.)

``Telemetry`` (the JAX package's, on the port's ``obs.metrics`` registry)
separates the two halves of an engine round: ``data_s`` is the time the
loop waited for the next batch, ``step_s`` the step from dispatch to the
synchronizing loss read. ``record()`` appends to the registry's ``step_s``
/ ``data_wait_s`` series (the stream ``train.py --metrics-out`` writes);
the accessors read straight out of it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.obs.metrics import MetricRegistry


def monotonic() -> float:
    """The port's one wall clock: monotonic, sub-microsecond resolution."""
    return time.perf_counter()


@dataclasses.dataclass(frozen=True)
class TimeStats:
    """min + median + IQR of a repeated measurement."""
    min_s: float
    median_s: float
    iqr_s: float
    iters: int

    def row(self, scale: float = 1e6) -> dict:
        """JSON-friendly dict, every timing emitter's row (default unit:
        microseconds)."""
        return {"min_us": self.min_s * scale,
                "median_us": self.median_s * scale,
                "iqr_us": self.iqr_s * scale,
                "iters": self.iters}


def stats_of(samples: Sequence[float]) -> TimeStats:
    if not samples:
        raise ValueError("no samples")
    xs = sorted(samples)
    n = len(xs)

    def q(p: float) -> float:
        # linear-interpolated quantile (numpy default), dependency-free
        i = p * (n - 1)
        lo = int(i)
        hi = min(lo + 1, n - 1)
        return xs[lo] + (i - lo) * (xs[hi] - xs[lo])

    return TimeStats(min_s=xs[0], median_s=q(0.5), iqr_s=q(0.75) - q(0.25),
                     iters=n)


def synchronize() -> None:
    """Wait for queued CUDA work, if this process has used CUDA at all."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def probe(fn: Callable[[], object], *, warmup: int = 1,
          iters: int = 5) -> TimeStats:
    """Time ``fn()`` ``iters`` times after ``warmup`` untimed calls (which
    absorb kernel builds and allocator growth), synchronizing CUDA after
    each call. Emits one ``timing.probe`` span when a tracer is installed."""
    from repro_torch.obs import spans
    with spans.span("timing.probe", warmup=warmup, iters=iters) as sp:
        for _ in range(warmup):
            fn()
            synchronize()
        samples = []
        for _ in range(iters):
            t0 = monotonic()
            fn()
            synchronize()
            samples.append(monotonic() - t0)
        stats = stats_of(samples)
        sp.set(min_us=stats.min_s * 1e6, median_us=stats.median_s * 1e6)
    return stats


class Telemetry:
    """Per-step wall-clock record of an engine run — a facade over an
    ``obs.metrics.MetricRegistry`` (module docstring).

    ``record(step_s, data_s)`` appends one step to the registry's
    ``step_s`` / ``data_wait_s`` series. The first ``skip`` steps
    (default 1) are excluded from the aggregate statistics — they absorb
    the kernels' build and the allocator's growth.
    """

    def __init__(self, skip: int = 1,
                 registry: Optional[MetricRegistry] = None):
        if skip < 0:
            raise ValueError("skip must be >= 0")
        self.skip = skip
        self.registry = registry if registry is not None else MetricRegistry()
        self._step = self.registry.series("step_s")
        self._data = self.registry.series("data_wait_s")

    @property
    def step_s(self) -> List[float]:
        """Per-step device wall times (live view of the registry series)."""
        return self._step.values

    @property
    def data_s(self) -> List[float]:
        """Per-step host data waits (live view of the registry series)."""
        return self._data.values

    @property
    def notes(self) -> List[str]:
        return self.registry.notes

    def note(self, msg: str) -> None:
        """Record a configuration observation (deduplicated)."""
        self.registry.note(msg)

    def __len__(self) -> int:
        return len(self._step)

    def record(self, step_s: float, data_s: float = 0.0) -> None:
        step = len(self._step)
        self._step.append(float(step_s), step=step)
        self._data.append(float(data_s), step=step)

    def _steady(self, window: Optional[int] = None) -> List[float]:
        vals = self._step.values
        steady = vals[self.skip:] if len(vals) > self.skip else list(vals)
        if window is not None and window > 0:
            steady = steady[-window:]
        return steady

    def median_step_s(self, window: Optional[int] = None) -> float:
        """Median steady step time — the interpolated ``stats_of`` median.
        ``window`` restricts to the most recent N steady steps."""
        steady = self._steady(window)
        if not steady:
            raise ValueError("no steps recorded")
        return stats_of(steady).median_s

    def mean_step_s(self) -> float:
        steady = self._steady()
        if not steady:
            raise ValueError("no steps recorded")
        return sum(steady) / len(steady)

    def stats(self, window: Optional[int] = None) -> TimeStats:
        """min/median/IQR over the steady-state step times (``skip``
        applied)."""
        steady = self._steady(window)
        if not steady:
            raise ValueError("no steps recorded")
        return stats_of(steady)

    def throughput(self, batch_size: int,
                   window: Optional[int] = None) -> float:
        """Black-box examples/s over the steady-state steps. ``window``
        estimates from only the last N steps."""
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        return batch_size / self.median_step_s(window)

    def drift(self, window: int) -> float:
        """Recent-to-overall median step-time ratio: > 1 means the run is
        slowing down (straggler, thermal, contention), < 1 speeding up.
        The scalar trigger for online re-planning."""
        if window < 1:
            raise ValueError("window must be >= 1")
        return self.median_step_s(window) / self.median_step_s()

    def summary(self, batch_size: Optional[int] = None) -> dict:
        data = self._data.values
        out = {
            "steps": len(self._step),
            "median_step_ms": self.median_step_s() * 1e3,
            "mean_step_ms": self.mean_step_s() * 1e3,
            "data_wait_ms": (sum(data[self.skip:])
                             / max(1, len(data) - self.skip)) * 1e3,
        }
        if batch_size is not None:
            out["examples_per_s"] = self.throughput(batch_size)
        if self.notes:
            out["notes"] = list(self.notes)
        return out
