"""Theorem 1 — asynchrony begets momentum (paper §IV-C, [Mitliagkas 2016]).

With g asynchronous groups and explicit momentum 0, the expected update obeys
    E V_{t+1} = (1 - 1/g) E V_t - (eta/g) E grad(W_t)
i.e. implicit momentum mu_impl = 1 - 1/g.

``measure_effective_momentum`` estimates the momentum modulus from an
observed parameter trace by least squares on the update recursion — the
estimator behind the paper's Fig. 6 "measured momentum" panels.
"""
from __future__ import annotations

import numpy as np


def implicit_momentum(g: int) -> float:
    return 1.0 - 1.0 / g


def total_momentum(g: int, explicit_mu: float) -> float:
    """Composition used by the optimizer: momenta compose like moduli."""
    return 1.0 - (1.0 - implicit_momentum(g)) * (1.0 - explicit_mu)


def optimal_explicit_momentum(g: int, mu_star_total: float) -> float:
    """Explicit momentum that restores the sync-optimal total momentum;
    0 (and an SE penalty) once implicit momentum exceeds mu_star_total."""
    mu_i = implicit_momentum(g)
    if mu_i >= mu_star_total:
        return 0.0
    return 1.0 - (1.0 - mu_star_total) / (1.0 - mu_i)


def measure_effective_momentum(param_trace: np.ndarray,
                               grads_at_trace: np.ndarray,
                               lr: float, *, fit_lr: bool = False) -> float:
    """Fit mu in  dW_{t+1} = mu dW_t - eta_eff * grad_t  by least squares
    over a flattened parameter trace (T, D). Returns the fitted momentum
    modulus. ``grads_at_trace``: gradients evaluated at W_t (T, D).

    ``fit_lr=False`` assumes ``eta_eff == lr`` (one-parameter fit — right
    when the trace comes from explicit-momentum SGD at a known step size).
    ``fit_lr=True`` fits (mu, eta_eff) jointly and ignores ``lr`` — the
    estimator for *replayed* asynchronous traces, where Theorem 1 predicts
    eta_eff = lr/g alongside mu = 1 - 1/g (the paper's Fig. 6 measured
    momentum; trajectories from ``exec.replayed_momentum_experiment``)."""
    w = np.asarray(param_trace, dtype=np.float64)
    g = np.asarray(grads_at_trace, dtype=np.float64)
    dw = np.diff(w, axis=0)                        # (T-1, D)
    if dw.shape[0] < 3:
        raise ValueError("trace too short")
    if fit_lr:
        y = dw[1:].ravel()
        X = np.stack([dw[:-1].ravel(), g[1:-1].ravel()], axis=1)
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        return float(coef[0])
    y = (dw[1:] + lr * g[1:-1]).ravel()            # target: mu * dW_t (+ lr-scale slack)
    x = dw[:-1].ravel()
    denom = float(x @ x)
    if denom == 0.0:
        return 0.0
    return float(x @ y) / denom


def async_quadratic_sim(*, g: int, eta: float, steps: int, runs: int = 200,
                        a: float = 1.0, seed: int = 0, w0: float = 1.0,
                        noise: float = 0.0) -> np.ndarray:
    """Simulate Theorem 1's exact model on a 1-D quadratic (loss = a w^2 / 2):
    g asynchronous workers with exponential (memoryless) service times — so
    each commit comes from a uniformly-random worker whose gradient was read
    at its own previous commit. Returns the run-averaged trajectory (steps+1,).

    The expected dynamics obey
        E w_{t+1} = E w_t + (1-1/g)(E w_t - E w_{t-1}) - (eta a / g) E w_t,
    i.e. an AR(2) with momentum coefficient exactly 1 - 1/g.
    """
    rng = np.random.default_rng(seed)
    traj = np.zeros((runs, steps + 1))
    for r in range(runs):
        w = w0
        read_w = np.full(g, w0)            # params each worker last read
        ws = [w]
        for t in range(steps):
            i = rng.integers(g)            # memoryless race -> uniform worker
            grad = a * read_w[i]
            if noise:
                grad += noise * rng.standard_normal()
            w = w - eta * grad
            read_w[i] = w                  # worker re-reads after commit
            ws.append(w)
        traj[r] = ws
    return traj.mean(axis=0)


def fit_ar2_momentum(traj: np.ndarray):
    """Fit the heavy-ball recursion  V_{t+1} = mu V_t - eta_eff W_t  on an
    expected trajectory. Returns (mu, eta_eff) — Theorem 1 predicts
    (1 - 1/g, eta/g)."""
    w = np.asarray(traj, dtype=np.float64)
    v = np.diff(w)
    y = v[1:]
    X = np.stack([v[:-1], w[1:-1]], axis=1)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    return float(coef[0]), float(-coef[1])


def measure_momentum_from_updates(updates: np.ndarray) -> float:
    """Momentum modulus from successive updates alone (autocorrelation
    estimator): mu ≈ <dW_{t+1}, dW_t> / <dW_t, dW_t>, averaged over t.
    Valid near a quadratic minimum where the gradient term is small noise."""
    u = np.asarray(updates, dtype=np.float64)
    num = float(np.sum(u[1:] * u[:-1]))
    den = float(np.sum(u[:-1] * u[:-1]))
    return num / den if den else 0.0
