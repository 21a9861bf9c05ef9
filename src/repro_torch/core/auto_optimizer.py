"""Algorithm 1 — Omnivore's automatic optimizer (paper §V-B, App E).

Epoch loop: adaptive grid search over (momentum, learning-rate) at the
current number of compute groups g; if the best explicit momentum is 0,
asynchrony's implicit momentum is already past optimal — halve g and
re-search. Cold start runs synchronously (scale-setting, App E-D), and the
initial g comes from the HE model's FC-saturation short-circuit.

The optimizer is decoupled from the execution substrate through ``Runner``:
    runner(state, *, g, mu, eta, steps, probe) -> (new_state, losses)
so the same Algorithm 1 drives CPU experiments (delayed SGD) and the SPMD
grouped step. The canonical Runner is an execution engine
(``repro_torch.engine.Engine`` — callable with exactly this protocol, built
by ``core.workload.make_runner``); any conforming callable works. A numpy
copy of the JAX package's ``core/auto_optimizer.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import hardware_model as hm

Runner = Callable[..., Tuple[object, np.ndarray]]

DEFAULT_MUS = (0.0, 0.3, 0.6, 0.9)
COLD_START_ETAS = (0.1, 0.01, 0.001, 0.0001, 0.00001)


@dataclasses.dataclass
class Decision:
    phase: str
    g: int
    mu: float
    eta: float
    loss: float


@dataclasses.dataclass
class OptimizerResult:
    state: object
    g: int
    mu: float
    eta: float
    decisions: List[Decision]
    losses: np.ndarray
    mp: int = 1        # model-parallel width of the planned mesh (the
    #                    engine's "mp" axis; from the planner Plan)


def _final_loss(losses, tail: int = 50) -> float:
    arr = np.asarray(losses, dtype=np.float64)
    arr = arr[np.isfinite(arr)]
    if arr.size == 0:
        return float("inf")
    return float(arr[-min(tail, arr.size):].mean())


def grid_search(runner: Runner, state, *, g: int, etas: Sequence[float],
                mus: Sequence[float], probe_steps: int,
                mu_cap: Optional[float] = None, eta_cap_at: Optional[float] = None):
    """Paper App E-C: run each (mu, eta) for probe_steps from the same
    checkpoint; return (mu*, eta*, loss*). Pruning: while eta == eta_last,
    don't search mu above mu_last."""
    best = (None, None, float("inf"))
    for eta in etas:
        for mu in mus:
            if (mu_cap is not None and eta_cap_at is not None
                    and eta == eta_cap_at and mu > mu_cap):
                continue
            _, losses = runner(state, g=g, mu=mu, eta=eta,
                               steps=probe_steps, probe=True)
            fl = _final_loss(losses)
            if np.isfinite(fl) and fl < best[2]:
                best = (mu, eta, fl)
    if best[0] is None:
        raise RuntimeError("all probe configurations diverged")
    # refinement near mu = 0 (paper: "if mu*=0, try 0.1 and 0.2 as well")
    if best[0] == 0.0:
        for mu in (0.1, 0.2):
            _, losses = runner(state, g=g, mu=mu, eta=best[1],
                               steps=probe_steps, probe=True)
            fl = _final_loss(losses)
            if fl < best[2]:
                best = (mu, best[1], fl)
    return best


def cold_start(runner: Runner, state, *, probe_steps: int,
               etas: Sequence[float] = COLD_START_ETAS):
    """Sync (g=1), mu=0.9; sweep eta high->low with early stop (App E-D)."""
    best = (0.9, None, float("inf"))
    prev = float("inf")
    for eta in etas:
        _, losses = runner(state, g=1, mu=0.9, eta=eta,
                           steps=probe_steps, probe=True)
        fl = _final_loss(losses)
        if np.isfinite(fl) and fl < best[2]:
            best = (0.9, eta, fl)
        if np.isfinite(fl) and fl > prev:
            break                          # getting worse: stop early
        prev = fl
    if best[1] is None:
        raise RuntimeError("cold start found no converging learning rate")
    return best


def algorithm1(runner: Runner, state, *, n_devices: int, epochs: int,
               epoch_steps: int, probe_steps: int,
               phase_times: Optional[hm.PhaseTimes] = None,
               g0: Optional[int] = None, plan=None,
               mus: Sequence[float] = DEFAULT_MUS) -> OptimizerResult:
    """Full Algorithm 1 with cold start and HE short-circuit.

    Initial g precedence: explicit ``g0`` > ``plan`` (a
    ``cluster.planner.Plan`` — or anything with a ``.g`` — from the
    heterogeneous time-to-convergence search) > homogeneous ``phase_times``
    FC-saturation short-circuit > fully async (g = N).

    A plan from the 2-D (g, mp) search carries a model-parallel width
    ``plan.mp``; it is validated against the device budget (g*mp <= N),
    passed through on the result (``OptimizerResult.mp``) and fixed for
    the run — Algorithm 1 adapts g (the staleness axis) only, because mp
    moves bytes, not gradients: SE is mp-invariant, so re-searching it
    per epoch would spend probes on a statistically neutral knob.
    """
    decisions: List[Decision] = []
    all_losses: List[np.ndarray] = []
    mp = int(getattr(plan, "mp", 1) or 1) if plan is not None else 1

    # --- cold start: synchronous scale-setting ---
    mu, eta, fl = cold_start(runner, state, probe_steps=probe_steps)
    state, losses = runner(state, g=1, mu=mu, eta=eta, steps=epoch_steps,
                           probe=False)
    all_losses.append(np.asarray(losses))
    decisions.append(Decision("cold", 1, mu, eta, _final_loss(losses)))
    eta_last, mu_last = eta, mu

    # --- initial g: explicit > planner > smallest FC-saturating (App
    # E-C1) > N ---
    if g0 is not None:
        g = g0
    elif plan is not None:
        g = int(plan.g)
        if not 1 <= g * mp <= n_devices:
            raise ValueError(f"plan (g={g}, mp={mp}) infeasible for "
                             f"N={n_devices}")
    elif phase_times is not None:
        g = hm.smallest_saturating_g(n_devices, phase_times)
    else:
        g = n_devices

    for _ in range(epochs):
        etas = (eta_last, eta_last / 10.0)
        mu, eta, fl = grid_search(runner, state, g=g, etas=etas, mus=mus,
                                  probe_steps=probe_steps,
                                  mu_cap=mu_last, eta_cap_at=eta_last)
        while mu == 0.0 and g > 1:
            g //= 2
            mu, eta, fl = grid_search(runner, state, g=g, etas=etas, mus=mus,
                                      probe_steps=probe_steps,
                                      mu_cap=mu_last, eta_cap_at=eta_last)
        state, losses = runner(state, g=g, mu=mu, eta=eta, steps=epoch_steps,
                               probe=False)
        all_losses.append(np.asarray(losses))
        decisions.append(Decision("epoch", g, mu, eta, _final_loss(losses)))
        eta_last, mu_last = eta, mu

    return OptimizerResult(state=state, g=g, mu=mu, eta=eta,
                           decisions=decisions,
                           losses=np.concatenate(all_losses), mp=mp)
