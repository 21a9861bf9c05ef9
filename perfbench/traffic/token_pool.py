"""A pool of training batches of uniform token ids.

A mix names this generator with ``"generator": "token_pool"`` and gives
``batch`` sequences of ``seq`` tokens and the ``pool``'s size: that many
distinct global batches, with next-token labels, made from the seed as
host int32 arrays, as a file-backed loader would hand them.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from harness.common import rng

POOL_TAG = 201


def make(mix: dict, config: dict, seed: int, seconds: float = 0.0,
         device=None) -> List[Dict]:
    r = rng(seed, POOL_TAG)
    b, s, v = int(mix["batch"]), int(mix["seq"]), int(config["vocab_size"])
    pool = []
    for _ in range(int(mix["pool"])):
        ids = r.integers(v, size=(b, s + 1), dtype=np.int64).astype(np.int32)
        pool.append({"tokens": np.ascontiguousarray(ids[:, :-1]),
                     "labels": np.ascontiguousarray(ids[:, 1:])})
    return pool
