"""Learning-rate schedules (paper App. F-G compares Omnivore's epoch-wise
re-tuning against CaffeNet's fixed step decay)."""
from __future__ import annotations

import math
from typing import Callable


def constant(lr: float) -> Callable[[int], float]:
    return lambda step: lr


def step_decay(lr: float, *, drop: float = 10.0,
               every: int = 100_000) -> Callable[[int], float]:
    """CaffeNet default: divide by `drop` every `every` iterations."""
    return lambda step: lr / (drop ** (step // every))


def cosine(lr: float, *, total_steps: int,
           final_frac: float = 0.1) -> Callable[[int], float]:
    def f(step):
        t = min(step / max(total_steps, 1), 1.0)
        return lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + math.cos(math.pi * t)))
    return f


def warmup_then(schedule: Callable[[int], float],
                warmup_steps: int) -> Callable[[int], float]:
    def f(step):
        if step < warmup_steps:
            return schedule(warmup_steps) * (step + 1) / warmup_steps
        return schedule(step)
    return f
