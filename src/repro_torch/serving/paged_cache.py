"""Paged KV cache: fixed-size pages + per-slot page tables, layered on the
dense ``(B, W, K, hd)`` ring-buffer layout from ``models.layers``.

Port of the JAX package's ``serving/paged_cache.py``; the allocator is a
verbatim numpy copy, the pools are torch tensors on the server's device.

Storage contract
----------------
The device pool is ``(L, num_pages, page_size, K, hd)`` for k and v; a
slot's logical cache is ``pages_per_slot`` pages whose ids live in its
page-table row, and gathering ``pool[table[b]]`` then reshaping yields
exactly the dense ``(W, K, hd)`` ring buffer (``W = pages_per_slot *
page_size``) the reference ``attention_decode`` reads — which is what
makes paged decode *bitwise* equal to the dense path (pinned in
``tests/test_torch_serving.py``).

Page 0 is a reserved scratch page, never allocated: freed / never-filled
table entries point at it, so an inactive slot's masked write targets
scratch and writes back the value it just read. Duplicate scatter indices
therefore only ever carry identical payloads and the update is
order-independent — deterministic slot recycling with no retracing.

A family with recurrent state (hybrid_moe) keeps it per slot beside the
pool, for every Mamba layer (``init_state``): ``ssm_h`` (n_mamba, S, H,
P, N) fp32 and ``ssm_conv`` (n_mamba, S, K-1, d_conv), the SSM state and
the conv tail. The pool then holds the attention layers alone. Admission
zeroes a slot's state, the prefill hands each admitted slot its prompt's
state, and decode advances the active slots' state in place.

The allocator is host-side (numpy tables, a free list): pages are
allocated lazily as a slot's sequence crosses page boundaries and
returned wholesale when the request retires, so peak KV memory follows
live tokens, not ``slots * max_seq``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.ssm import init_ssm_cache


@dataclasses.dataclass(frozen=True)
class PagedCacheSpec:
    """Static shape of a paged KV pool (one pool per model, all layers)."""
    num_slots: int
    page_size: int
    pages_per_slot: int
    num_layers: int
    kv_heads: int
    head_dim: int
    dtype: str = "float32"

    @property
    def seq_capacity(self) -> int:
        """W: the dense ring-buffer width a full table row gathers to."""
        return self.pages_per_slot * self.page_size

    @property
    def num_pages(self) -> int:
        """Pool size including the reserved scratch page 0."""
        return 1 + self.num_slots * self.pages_per_slot

    @classmethod
    def for_config(cls, cfg: ArchConfig, *, num_slots: int, page_size: int,
                   max_seq: int, window: Optional[int] = None
                   ) -> "PagedCacheSpec":
        W = min(window, max_seq) if window is not None else max_seq
        if W % page_size:
            raise ValueError(
                f"page_size={page_size} must divide the cache width W={W} "
                "(bitwise parity with the dense ring buffer needs the "
                "gathered view to be exactly (B, W, K, hd))")
        layers = (cfg.layer_kinds.count("attention")
                  if cfg.arch_type == "hybrid_moe" else cfg.num_layers)
        return cls(num_slots=num_slots, page_size=page_size,
                   pages_per_slot=W // page_size, num_layers=layers,
                   kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                   dtype=cfg.compute_dtype)


def init_pages(spec: PagedCacheSpec, device="cpu"):
    """Zero-filled device pools: {"k","v"}: (L, P, page, K, hd)."""
    shape = (spec.num_layers, spec.num_pages, spec.page_size,
             spec.kv_heads, spec.head_dim)
    dt = getattr(torch, spec.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_state(cfg: ArchConfig, num_slots: int, device="cpu"):
    """Zero per-slot recurrent state (module docstring): {"ssm_h",
    "ssm_conv"} for hybrid_moe, {} for the families that keep none."""
    if cfg.arch_type != "hybrid_moe":
        return {}
    n = cfg.layer_kinds.count("mamba")
    one = init_ssm_cache(num_slots, cfg, device)
    return {"ssm_" + k: torch.zeros((n,) + a.shape, dtype=a.dtype,
                                    device=device)
            for k, a in one.items()}


class PageAllocator:
    """Host-side page bookkeeping: free list + per-slot tables.

    Tables are plain numpy, copied to the device for each step as a
    changing-value, fixed-shape operand. Page 0 is never handed out.
    """

    def __init__(self, spec: PagedCacheSpec):
        self.spec = spec
        self._free = list(range(spec.num_pages - 1, 0, -1))  # pop() -> low ids
        self.tables = np.zeros((spec.num_slots, spec.pages_per_slot),
                               dtype=np.int32)
        self._owned = [0] * spec.num_slots  # pages allocated per slot

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.spec.num_pages - 1 - len(self._free)

    def can_fit(self, length: int) -> bool:
        need = -(-min(length, self.spec.seq_capacity) // self.spec.page_size)
        return len(self._free) >= need

    def ensure(self, slot: int, length: int) -> None:
        """Grow slot's table so it covers ``length`` cache positions.

        Ring slots wrap at seq_capacity, so a slot never needs more than
        pages_per_slot pages. Raises if the pool is exhausted — admission
        control (``can_fit``) is the caller's job.
        """
        need = -(-min(length, self.spec.seq_capacity) // self.spec.page_size)
        while self._owned[slot] < need:
            if not self._free:
                raise RuntimeError(
                    f"paged KV pool exhausted ({self.spec.num_pages} pages, "
                    f"slot {slot} needs page {self._owned[slot]})")
            self.tables[slot, self._owned[slot]] = self._free.pop()
            self._owned[slot] += 1

    def release(self, slot: int) -> None:
        """Retire a request: return its pages, point the row at scratch."""
        for i in range(self._owned[slot]):
            self._free.append(int(self.tables[slot, i]))
        self.tables[slot, :] = 0
        self._owned[slot] = 0
