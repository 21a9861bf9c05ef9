"""Open-loop chat traffic: requests whose prompt and answer lengths follow
the mix's log-normal distributions and whose gaps between arrivals follow
a gamma distribution (shape 1: Poisson arrivals; under 1: bursts).

A mix names this generator with ``"generator": "chat"`` and gives
``rate_per_s``, ``arrival_shape``, and ``prompt_tokens`` and
``gen_tokens`` as ``{"mean", "sigma", "min", "max"}``: the distribution's
mean and the standard deviation of its logarithm, and the range it is
clipped to.

Every seed offers the same work in another order. A run of ``seconds``
offers n = round(rate x seconds) requests; the n prompt lengths, the n
answer lengths and the n gaps are their distributions' quantiles at
(i + 0.5) / n, and the gaps are scaled so that the last request arrives
at ``seconds``. The run's ``--seed`` orders the gaps, the prompt lengths
and the answer lengths, each by a permutation of its own, and draws each
prompt's token ids, keyed by (seed, rid).
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np

from harness.common import rng

ORDER_TAG, PROMPT_TAG = 202, 203


@dataclasses.dataclass(frozen=True)
class ChatRequest:
    rid: int
    arrival: float          # seconds from the window's start
    prompt: np.ndarray      # (P,) int32
    gen: int                # tokens to generate, greedy


def grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(spec: dict, n: int) -> np.ndarray:
    """The n quantiles of a log-normal of mean ``spec["mean"]`` and
    log-deviation ``spec["sigma"]``, rounded and clipped to
    [``min``, ``max``]."""
    sigma = float(spec["sigma"])
    mu = math.log(float(spec["mean"])) - 0.5 * sigma * sigma
    z = np.array([NormalDist().inv_cdf(u) for u in grid(n)])
    x = np.rint(np.exp(mu + sigma * z)).astype(np.int64)
    return np.clip(x, int(spec["min"]), int(spec["max"]))


def gaps(shape: float, n: int) -> np.ndarray:
    """The n quantiles of a gamma distribution of ``shape`` and mean 1."""
    from scipy.special import gammaincinv
    return gammaincinv(shape, grid(n)) / shape


def count(mix: dict, seconds: float) -> int:
    return max(1, int(round(float(mix["rate_per_s"]) * seconds)))


def prompt_lengths(mix: dict, seconds: float) -> List[int]:
    """The prompt lengths a run of ``seconds`` offers (every seed's)."""
    return sorted(int(x) for x in lengths(mix["prompt_tokens"],
                                          count(mix, seconds)))


def make(mix: dict, config: dict, seed: int, seconds: float,
         device=None) -> List[ChatRequest]:
    n = count(mix, seconds)
    order = rng(seed, ORDER_TAG)
    g = gaps(float(mix.get("arrival_shape", 1.0)), n)[order.permutation(n)]
    arrivals = np.cumsum(g) * (seconds / g.sum())
    plens = lengths(mix["prompt_tokens"], n)[order.permutation(n)]
    gens = lengths(mix["gen_tokens"], n)[order.permutation(n)]
    v = int(config["vocab_size"])
    return [ChatRequest(rid=rid, arrival=float(arrivals[rid]),
                        prompt=rng(seed, PROMPT_TAG, rid).integers(
                            v, size=int(plens[rid])).astype(np.int32),
                        gen=int(gens[rid]))
            for rid in range(n)]
