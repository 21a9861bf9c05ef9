"""Lightweight GP-EI Bayesian optimizer over (log-eta, mu, log2-g) — the
Snoek-style baseline the paper compares against (§VI-C2, Fig. 34).
NumPy-only (RBF kernel GP + expected improvement on a candidate grid)."""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np


def _rbf(a: np.ndarray, b: np.ndarray, ls: np.ndarray) -> np.ndarray:
    d = (a[:, None, :] - b[None, :, :]) / ls
    return np.exp(-0.5 * np.sum(d * d, axis=-1))


@dataclasses.dataclass
class BayesResult:
    best_x: Tuple[float, float, int]     # (eta, mu, g)
    best_y: float
    history: List[Tuple[Tuple[float, float, int], float]]
    evaluations: int


def _encode(eta, mu, g):
    return np.array([np.log10(eta), mu, np.log2(g)])


def gp_ei_minimize(objective: Callable[[float, float, int], float],
                   *, etas: Sequence[float], mus: Sequence[float],
                   gs: Sequence[int], budget: int, seed: int = 0,
                   noise: float = 1e-6) -> BayesResult:
    """Minimize objective(eta, mu, g) with GP-EI over the finite grid."""
    rng = np.random.default_rng(seed)
    grid = [(e, m, g) for e in etas for m in mus for g in gs]
    X_all = np.stack([_encode(*p) for p in grid])
    ls = np.maximum(X_all.std(axis=0), 1e-3)

    history: List[Tuple[Tuple[float, float, int], float]] = []
    # 3 random warmup points
    idx0 = rng.choice(len(grid), size=min(3, budget), replace=False)
    for i in idx0:
        y = float(objective(*grid[i]))
        history.append((grid[i], y))

    while len(history) < budget:
        Xo = np.stack([_encode(*h[0]) for h in history])
        yo = np.array([h[1] for h in history])
        finite = np.isfinite(yo)
        ycap = yo.copy()
        ycap[~finite] = (yo[finite].max() if finite.any() else 1e3) * 2
        mean, std = ycap.mean(), max(ycap.std(), 1e-6)
        yn = (ycap - mean) / std
        K = _rbf(Xo, Xo, ls) + noise * np.eye(len(Xo))
        Kinv = np.linalg.inv(K)
        Ks = _rbf(X_all, Xo, ls)
        mu_pred = Ks @ Kinv @ yn
        var = np.maximum(1.0 - np.einsum("ij,jk,ik->i", Ks, Kinv, Ks), 1e-9)
        sd = np.sqrt(var)
        best = yn.min()
        z = (best - mu_pred) / sd
        # EI with standard normal cdf/pdf
        import math
        cdf = 0.5 * (1 + np.vectorize(math.erf)(z / np.sqrt(2)))
        pdf = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)
        ei = sd * (z * cdf + pdf)
        # never re-evaluate
        seen = {h[0] for h in history}
        order = np.argsort(-ei)
        nxt = next(i for i in order if grid[i] not in seen)
        y = float(objective(*grid[nxt]))
        history.append((grid[nxt], y))

    finite_hist = [(x, y) for x, y in history if np.isfinite(y)]
    bx, by = min(finite_hist, key=lambda h: h[1])
    return BayesResult(best_x=bx, best_y=by, history=history,
                       evaluations=len(history))
