"""Gradient bucketing for the overlapped SPMD grouped step (the JAX
package's ``engine/buckets.py``).

The whole-tree step gathers every leaf only after the entire backward pass
has produced the full gradient tree, so the exchange and the backward
compute run one after the other. Bucketing cuts the tree into a handful of
flat slabs, and each slab's gathers depend only on its own leaves: the
gather of an early bucket starts while the backward pass is still
producing later buckets (``engine.spmd``).

Assignment is static (shapes and dtypes only):

- leaves are packed in **reverse flatten order**, the order reverse-mode
  autodiff produces gradients (output-side layers first), so the first
  bucket closes as early in the backward pass as possible;
- a bucket only holds leaves of one (dtype, is_head) class: mixed dtypes
  cannot share a slab without casts that change bits, and head (merged-FC)
  leaves take other update coefficients;
- a bucket closes when it reaches ``bucket_bytes`` (a target, not a cap: a
  single leaf larger than the target still forms one bucket).

Packing is ``torch.cat`` of ``reshape(-1)`` views, pure data movement, so
the bucketed step stays bitwise the per-leaf one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One slab: a run of leaves (flat-tree indices) sharing dtype and
    head-ness, packed into a single 1-D gather unit."""
    indices: Tuple[int, ...]          # core.tree.leaves indices
    shapes: Tuple[Tuple[int, ...], ...]
    dtype: str                        # dtype name, as numpy spells it
    is_head: bool

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(math.prod(s) for s in self.shapes)

    @property
    def num_elements(self) -> int:
        return sum(self.sizes)

    @property
    def nbytes(self) -> int:
        return self.num_elements * _itemsize(self.dtype)


def _dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the JAX package's name)."""
    return str(dtype).removeprefix("torch.")


def _itemsize(name: str) -> int:
    return torch.empty(0, dtype=getattr(torch, name)).element_size()


def assign_buckets(leaves: Sequence, head_flags: Sequence[bool],
                   bucket_bytes: int) -> Tuple[Bucket, ...]:
    """Static bucket assignment over flat leaves (only ``.shape`` and
    ``.dtype`` are read). ``head_flags``: parallel list of merged-FC head
    markers. ``bucket_bytes``: per-bucket size target, > 0 (the caller
    owns the ``bucket_bytes <= 0`` whole-tree arm)."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    if len(leaves) != len(head_flags):
        raise ValueError(f"{len(leaves)} leaves vs {len(head_flags)} "
                         "head flags")
    buckets: List[Bucket] = []
    cur_idx: List[int] = []
    cur_shapes: List[Tuple[int, ...]] = []
    cur_key = None          # (dtype name, is_head)
    cur_bytes = 0

    def close():
        nonlocal cur_idx, cur_shapes, cur_bytes
        if cur_idx:
            buckets.append(Bucket(indices=tuple(cur_idx),
                                  shapes=tuple(cur_shapes),
                                  dtype=cur_key[0], is_head=cur_key[1]))
        cur_idx, cur_shapes, cur_bytes = [], [], 0

    # reverse flatten order = backward production order (module doc)
    for i in reversed(range(len(leaves))):
        leaf = leaves[i]
        key = (_dtype_name(leaf.dtype), bool(head_flags[i]))
        shape = tuple(int(d) for d in leaf.shape)
        nbytes = math.prod(shape) * _itemsize(key[0])
        if cur_key != key or (cur_idx and cur_bytes + nbytes > bucket_bytes):
            close()
            cur_key = key
        cur_idx.append(i)
        cur_shapes.append(shape)
        cur_bytes += nbytes
    close()
    return tuple(buckets)


def pack_bucket(bucket: Bucket, flat_leaves: Sequence) -> torch.Tensor:
    """Concatenate the bucket's leaves (flattened) into one (n,) slab:
    pure data movement, no arithmetic."""
    parts = [flat_leaves[i].reshape(-1) for i in bucket.indices]
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts)


def unpack_bucket(bucket: Bucket, slab: torch.Tensor) -> List[torch.Tensor]:
    """Split a slab back into leaf tensors, in ``bucket.indices`` order.
    ``slab`` is (n,) or (g, n): leading dims are kept, so a gathered
    (g, n) slab unpacks to per-leaf (g, *shape) stacks (views)."""
    lead = tuple(slab.shape[:-1])
    out, off = [], 0
    for shape, size in zip(bucket.shapes, bucket.sizes):
        out.append(slab[..., off:off + size].reshape(lead + shape))
        off += size
    if off != slab.shape[-1]:
        raise ValueError(f"slab has {slab.shape[-1]} elements, bucket "
                         f"expects {off}")
    return out
