"""Statistical-efficiency (SE) bookkeeping — paper §IV-C / App F-C.

    SE(g)      = iterations to reach a target loss with g groups
    P_SE(S)    = SE(S) / SE(0)
    P_HE(S)    = HE(S) / HE(0)
    P_total(S) = P_SE * P_HE          (time-to-accuracy, normalized to sync)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.implicit_momentum import implicit_momentum


def iterations_to_loss(losses: Sequence[float], target: float,
                       smooth: int = 5) -> Optional[int]:
    """First iteration at which the running-mean loss reaches ``target``."""
    arr = np.asarray(losses, dtype=np.float64)
    if arr.size == 0:
        return None
    if smooth > 1:
        kernel = np.ones(min(smooth, arr.size)) / min(smooth, arr.size)
        arr = np.convolve(arr, kernel, mode="valid")
    hits = np.nonzero(arr <= target)[0]
    return int(hits[0]) if hits.size else None


@dataclasses.dataclass
class TradeoffPoint:
    g: int
    mu: float
    eta: float
    he_time: float                 # seconds / iteration (model or measured)
    se_iters: Optional[int]        # iterations to target loss

    @property
    def total_time(self) -> Optional[float]:
        if self.se_iters is None:
            return None
        return self.he_time * self.se_iters


def penalty_ratio(value, baseline) -> Optional[float]:
    """Normalized penalty with explicit degenerate-case semantics.

    ``None``     — unknown: either side never reached the target
                   (``se_iters is None``).
    ``math.inf`` — the sync baseline hit the target instantly (0
                   iterations) but this point didn't: infinitely worse.
    ``1.0``      — both sides are 0: equally instant.

    (A plain truthiness test, as previously used, silently collapsed a
    legitimate 0 to "unknown" and a 0 baseline to a ZeroDivisionError.)
    """
    if value is None or baseline is None:
        return None
    if baseline == 0:
        return math.inf if value > 0 else 1.0
    return value / baseline


def penalties(points: Dict[int, TradeoffPoint]):
    """Normalize a {g: point} sweep to the sync point (paper's P_* curves).

    Requires the sync (g=1) baseline; missing/zero SE data degrades to the
    explicit ``None``/``math.inf`` semantics of ``penalty_ratio``.
    """
    if 1 not in points:
        raise ValueError("penalties() needs the sync baseline (g=1 point)")
    base = points[1]
    out = {}
    for g, pt in sorted(points.items()):
        out[g] = {
            "P_HE": pt.he_time / base.he_time,
            "P_SE": penalty_ratio(pt.se_iters, base.se_iters),
            "P_total": penalty_ratio(pt.total_time, base.total_time),
            "implicit_momentum": implicit_momentum(g),
            "mu": pt.mu, "eta": pt.eta,
        }
    return out


def measured_se_from_replay(replay_losses: Mapping[int, Sequence[float]],
                            target: float, *, smooth: int = 5
                            ) -> Dict[int, Dict[str, Optional[float]]]:
    """SE calibration from *executed* traces rather than the analytic
    penalty: ``replay_losses`` maps g -> the loss curve of an
    ``exec.replay`` run along a g-group event trace (e.g. from
    ``queue_sim.simulate(..., return_trace=True)``).

    Returns ``{g: {"se_iters", "P_SE"}}`` — iterations to ``target`` and
    the penalty normalized to the g=1 entry (``penalty_ratio`` semantics:
    ``None`` when either side never converged). The P_SE values plug
    straight into the planner (``cluster.planner.best_allocation(
    se_penalties=...)``), which is how Algorithm 1's initial-g choice can
    be calibrated from executions.

    Like ``penalties()``, requires the sync baseline — P_SE is
    meaningless without a g=1 curve to normalize against.
    """
    iters = {int(g): iterations_to_loss(l, target, smooth=smooth)
             for g, l in replay_losses.items()}
    if 1 not in iters:
        raise ValueError(
            "measured_se_from_replay() needs the sync baseline "
            "(a g=1 replayed loss curve)")
    base = iters[1]
    return {g: {"se_iters": n, "P_SE": penalty_ratio(n, base)}
            for g, n in sorted(iters.items())}


def predict_se_penalty(g: int, mu_star_total: float, sharpness: float = 4.0):
    """Qualitative SE-penalty model: no penalty while implicit momentum stays
    below the optimal total momentum, growing penalty beyond (Fig. 6/7)."""
    mu_i = implicit_momentum(g)
    if mu_i <= mu_star_total:
        return 1.0
    return float(1.0 + sharpness * (mu_i - mu_star_total) / (1 - mu_star_total))
