"""Closed form of g sequential momentum-SGD sub-steps on round-start
gradients (the grouped execution strategy, paper Fig. 17(b)).

Each sub-step i of a round applies paper eq. (3)-(4) with gradient g_i that
was evaluated at the *round-start* parameters, so the gradients are
constants of the recurrence and only the weight-decay term couples to the
evolving parameters:

    V_{i+1} = mu * V_i - eta * (g_i + lambda * W_i)
    W_{i+1} = W_i + V_{i+1}

which is the 2x2 linear recurrence

    [W_{i+1}]   [1 - eta*lambda   mu] [W_i]   [-eta]
    [V_{i+1}] = [   -eta*lambda   mu] [V_i] + [-eta] * g_i

Unrolling g steps (the algebra of "Asynchrony begets Momentum",
arXiv:1605.09774) gives one fused update over the stacked gradients:

    [W_g]       [W_0]   sum_i  [a_i]
    [V_g] = A^g [V_0] +        [b_i] * g_i,   [a_i; b_i] = A^{g-1-i} b

With lambda = 0 this is the familiar  W += sum_i a_i g_i,
V = mu^g V + sum_i b_i g_i  with a_i, b_i polynomials in mu. All
coefficients depend only on (g, eta, mu, lambda) — static hyperparameters —
so they are computed here once in float64 and handed to the update as
fp32 scalars. See docs/fused_update.md for the full derivation.

A verbatim numpy copy of the JAX package's ``optim/closed_form.py`` (the
port imports nothing of that package): the coefficients are bitwise the
same.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def _weight_scales(num_groups: int,
                   group_weights: Optional[Sequence[float]]):
    """Per-group gradient scales ``g * w_i / sum(w)``.

    Weighted grouped averaging (heterogeneous batch shares, see
    ``cluster.allocator``): group i's gradient enters every update scaled
    so that the round's total step matches a batch-share-weighted average.
    Uniform weights give scales of exactly 1.0 — a bitwise no-op — so the
    weighted path reduces to the unweighted one.
    """
    if group_weights is None:
        return None
    if len(group_weights) != num_groups:
        raise ValueError(f"need {num_groups} group weights, got "
                         f"{len(group_weights)}")
    w = [float(x) for x in group_weights]
    if any(x < 0.0 for x in w) or sum(w) <= 0.0:
        raise ValueError("group weights must be >= 0 with positive sum")
    s = sum(w)
    return [num_groups * x / s for x in w]


@dataclasses.dataclass(frozen=True)
class GroupedCoeffs:
    """Scalar coefficients of the fused g-sub-step update.

    W_new = cww*W + cwv*V + sum_i a[i]*g_i
    V_new = cvw*W + cvv*V + sum_i b[i]*g_i

    Frozen + tuple-valued so instances are hashable.
    """
    a: tuple            # per-group W coefficients, len g
    b: tuple            # per-group V coefficients, len g
    cww: float
    cwv: float
    cvw: float
    cvv: float

    @property
    def num_groups(self) -> int:
        return len(self.a)


def grouped_coeffs(num_groups: int, *, lr: float, momentum: float = 0.0,
                   weight_decay: float = 0.0,
                   group_weights: Optional[Sequence[float]] = None
                   ) -> GroupedCoeffs:
    """Coefficients of g sequential backbone sub-steps (staleness 0..g-1).

    a[i], b[i] = A^{g-1-i} @ (-eta, -eta); (cww..cvv) = A^g. Group i's
    gradient lands i updates stale, so it passes through g-1-i further
    applications of A — exactly the sequential scan, collapsed.

    ``group_weights`` (unequal batch shares): sub-step i's gradient is
    scaled by ``g * w_i / sum(w)``, i.e. its input vector becomes
    ``scale_i * (-eta, -eta)`` — linear, so only a[i], b[i] change.
    """
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    scales = _weight_scales(num_groups, group_weights)
    A = np.array([[1.0 - lr * weight_decay, momentum],
                  [-lr * weight_decay, momentum]], dtype=np.float64)
    bvec = np.array([-lr, -lr], dtype=np.float64)
    a = np.zeros(num_groups, dtype=np.float64)
    b = np.zeros(num_groups, dtype=np.float64)
    M = np.eye(2, dtype=np.float64)            # A^k, k = g-1-i
    for k in range(num_groups):
        i = num_groups - 1 - k
        a[i], b[i] = M @ bvec
        if scales is not None:
            a[i] *= scales[i]
            b[i] *= scales[i]
        M = A @ M
    return GroupedCoeffs(a=tuple(a.tolist()), b=tuple(b.tolist()),
                         cww=float(M[0, 0]), cwv=float(M[0, 1]),
                         cvw=float(M[1, 0]), cvv=float(M[1, 1]))


def head_coeffs(num_groups: int, *, lr: float, momentum: float = 0.0,
                weight_decay: float = 0.0,
                group_weights: Optional[Sequence[float]] = None
                ) -> GroupedCoeffs:
    """Merged-FC head: ONE zero-staleness update with the group-averaged
    gradient per round. Same fused form — a single application of A with
    the input vector split 1/g (or the normalized ``group_weights``)
    across the stacked gradients."""
    one = grouped_coeffs(1, lr=lr, momentum=momentum,
                         weight_decay=weight_decay)
    if group_weights is None:
        shares = [1.0 / num_groups] * num_groups
    else:
        # _weight_scales validates; scale_i / g = w_i / sum(w)
        shares = [s / num_groups
                  for s in _weight_scales(num_groups, group_weights)]
    return GroupedCoeffs(a=tuple(one.a[0] * s for s in shares),
                         b=tuple(one.b[0] * s for s in shares),
                         cww=one.cww, cwv=one.cwv, cvw=one.cvw, cvv=one.cvv)
