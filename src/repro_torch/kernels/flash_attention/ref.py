"""Plain PyTorch versions of flash attention.

``attention_ref`` is the JAX package's ``kernels/flash_attention/ref.py``
oracle (multi-head, one K/V head per query head). ``flash_attention_ref``
is the plain version of ``ops.flash_attention`` itself: grouped-query
heads without repeating K/V (head ``h`` reads kv head ``h // G``) and
per-row ``q_offsets``, the same masks as the CUDA kernel. It is the CPU
path of the wrapper and the yardstick the kernel is held to on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q,k,v: (B, S, H, hd) (same head count). Returns (B, S, H, hd)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(hd)
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    scores = torch.where(ok, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offsets=None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H = K*G; ``q_offsets``:
    optional (B,) absolute position of each row's first query. Returns
    (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[None, :]
    if q_offsets is not None:
        qpos = qpos + q_offsets.long()[:, None]
    qpos = qpos.expand(b, sq)[:, :, None]                  # (B, Sq, 1)
    kpos = torch.arange(sk, device=q.device)[None, None, :]
    ok = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    scores = torch.where(ok[:, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, h, hd)
