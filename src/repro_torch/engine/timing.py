"""Monotonic timing: the port's one wall clock and its measurement probe.

``monotonic()`` is ``time.perf_counter`` as in the JAX package's
``engine/timing.py``. ``probe`` times a callable on that clock; CUDA work
is asynchronous, so every timed call ends in ``torch.cuda.synchronize``
whenever CUDA is in use, and the clock reads the finished work, not its
enqueue. (Kernel times on the card come from CUDA events in
``chip_smoke.py``; ``probe`` is the host-clock view of a whole call.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch


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
