"""Compute groups — the paper's execution-strategy axis (§IV-A).

``g`` groups of ``k = N/g`` devices each. Within a group: synchronous
data-parallel SGD over the group's batch. Across groups: asynchronous
round-robin updates (staleness S = g - 1). ``group_batch_split`` reshapes
a global batch so axis 0 enumerates groups (the JAX package's
``core/compute_groups.py``, on trees of tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import tree as T


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    num_groups: int               # g
    num_devices: int = 1          # N (conv-phase devices in paper terms)

    def __post_init__(self):
        if self.num_devices % self.num_groups:
            raise ValueError(
                f"g={self.num_groups} must divide N={self.num_devices}")

    @property
    def staleness(self) -> int:  # S
        return self.num_groups - 1

    @property
    def group_size(self) -> int:  # k
        return self.num_devices // self.num_groups

    @property
    def implicit_momentum(self) -> float:
        """Theorem 1: asynchrony contributes momentum 1 - 1/g."""
        return 1.0 - 1.0 / self.num_groups


def group_batch_split(batch, g: int, sizes: Optional[Sequence[int]] = None):
    """Split every leaf (B, ...) into one microbatch per group, axis 0 = g.

    Equal shares (``sizes=None``): reshape (B, ...) -> (g, B/g, ...).

    Unequal shares (``sizes`` from a heterogeneous allocation): each group
    gets its own contiguous slice, wrap-filled (examples cycled) to
    ``max(sizes)`` so all microbatches share a shape. A group of size ``s``
    cycled to ``b = max(sizes)`` repeats its first ``b mod s`` examples
    once more than the rest: an O(1/b) bias of its microbatch mean, zero
    when ``s`` divides ``b`` (the bound is derived in the JAX package's
    docstring). Cross-group weighting comes from
    ``make_grouped_train_step(group_weights=...)``, not from here.
    """
    if sizes is not None:
        sizes = tuple(int(s) for s in sizes)
        if len(sizes) != g:
            raise ValueError(f"need {g} sizes, got {len(sizes)}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"every group needs >= 1 example, got {sizes}")
        if len(set(sizes)) > 1:
            return _group_batch_split_sized(batch, sizes)
        # equal sizes: fall through to the plain reshape

    def split(x):
        b = x.shape[0]
        if sizes is not None and b != sum(sizes):
            raise ValueError(f"batch {b} != sum(sizes)={sum(sizes)}")
        if b % g:
            raise ValueError(f"batch {b} not divisible by g={g}")
        return x.reshape(g, b // g, *x.shape[1:])
    return T.tree_map(split, batch)


def _group_batch_split_sized(batch, sizes: Sequence[int]):
    """Ragged split stacked to (g, max(sizes), ...) by cycling each group's
    own slice (a gather with host-computed indices)."""
    g, total, bmax = len(sizes), sum(sizes), max(sizes)
    offsets = np.cumsum([0] + list(sizes[:-1]))
    idx = np.concatenate([off + (np.arange(bmax) % s)
                          for off, s in zip(offsets, sizes)])

    def split(x):
        if x.shape[0] != total:
            raise ValueError(f"batch {x.shape[0]} != sum(sizes)={total}")
        sel = torch.from_numpy(idx).to(x.device)
        return x[sel].reshape(g, bmax, *x.shape[1:])
    return T.tree_map(split, batch)
