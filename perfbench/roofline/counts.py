"""Necessary operations and bytes: what every family shares (the peaks,
the least time, the grouped update) and, by the configuration's
``family``, its own counts from its shapes (``roofline/<family>.py``).

These count the work an operation needs at the cell's shapes, not what a
kernel happens to run: no recomputation (remat), no padding rows, each
input byte read once and each output byte written once. A kernel that is
split or fused later is held to the same count.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

F32, BF16 = 4, 2
_PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peak(name: str) -> float:
    return float(_PEAKS["peaks"][name]["value"])


def flop_peak(precision: str) -> float:
    """The tensor-core rate of a configuration's stated precision."""
    return peak(_PEAKS["precision_peak"][precision])


def bound_s(flops: float, nbytes: float, flop_s: float) -> float:
    """The least time: the larger of operations / peak and bytes / HBM."""
    return max(flops / flop_s, nbytes / peak("hbm_bytes_s"))


def of(cfg: dict):
    """The counts of the configuration's family: ``roofline/<family>.py``."""
    return importlib.import_module(f"roofline.{cfg['family']}")


def update_bytes(n_params: int, groups: int, nbytes: int = F32) -> float:
    """B1, the closed-form grouped update, reads W, V and the g stacked
    gradients and writes W and V."""
    return float(n_params) * nbytes * (4 + groups)
