"""Plain PyTorch version of paged decode attention (the dense gather).

Port of the JAX package's ``kernels/paged_attention/ref.py``: gathers
exactly the ``(B, W, K, hd)`` ring view (``pool[table].reshape``), applies
the per-row validity mask, and runs the same grouped einsum / softmax as
the serving decode's plain arm. The CPU path of ``ops.paged_attention``
and the yardstick the CUDA kernel is held to on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def valid_mask(pos: torch.Tensor, W: int,
               window: Optional[int]) -> torch.Tensor:
    """Per-row ring validity, (B, W) bool: which of the W gathered slots
    hold positions row b may attend to at ``pos[b]``."""
    slots = torch.arange(W, device=pos.device)[None, :]
    posb = pos[:, None].long()
    if window is not None:
        base = posb - (posb % W)
        abs_pos = torch.where(slots <= (posb % W), base + slots,
                              base - W + slots)
    else:
        abs_pos = slots.expand(pos.shape[0], W)
    valid = (abs_pos <= posb) & (abs_pos >= 0)
    if window is not None:
        valid &= abs_pos > (posb - window)
    return valid


def paged_attention_ref(q, k_pages, v_pages, table, pos, *, window=None):
    """Same signature/layout as ``ops.paged_attention`` (q: (B,1,H,hd)),
    computed via the dense gathered copy."""
    b, sq, h, hd = q.shape
    _, page, kh, _ = k_pages.shape
    W = table.shape[1] * page
    g = h // kh
    idx = table.long()
    ck = k_pages[idx].reshape(b, W, kh, hd)
    cv = v_pages[idx].reshape(b, W, kh, hd)
    qg = q.reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, ck) / math.sqrt(hd)
    s = s.float()
    ok = valid_mask(pos, W, window)
    s = s + torch.where(ok, 0.0, -1e30)[:, None, None, None, :]
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, cv)
    return out.reshape(b, sq, h, hd)
