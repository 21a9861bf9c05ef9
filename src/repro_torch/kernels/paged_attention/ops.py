"""Public wrapper: in-kernel paged flash-decode.

Takes the serving decode shapes as they are — q ``(B, 1, H, hd)`` (one
rotated query token per slot), one layer's page pools ``(P, page, K,
hd)``, the slot page tables ``(B, n_pages)`` int32 and the per-row
positions ``(B,)`` int32 — and returns ``(B, 1, H, hd)``. The GQA grouping
(H = K * G, head ``k * G + g``) matches ``models.layers._grouped_scores``.

A CUDA tensor launches ``csrc/paged_attention.cu`` (or raises); a CPU
tensor takes the plain version, ``ref.paged_attention_ref``. Every launch
adds one to ``paged_attention.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

KERNEL = "paged_attention"
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``paged_attention_launch``'s C signature, in order
ARGTYPES = [_P] * 6 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]


def _check(q, k_pages, v_pages, table, pos, G: int) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("table", table), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {tuple(DTYPES)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"pool dtypes {k_pages.dtype}/{v_pages.dtype} != "
                        f"q dtype {q.dtype}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"table/pos must be int32, not "
                        f"{table.dtype}/{pos.dtype}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"v_pages {tuple(v_pages.shape)} != k_pages "
                         f"{tuple(k_pages.shape)}")
    B, _, _, hd = q.shape
    if table.dim() != 2 or table.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"table {tuple(table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {B}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if G > MAX_GROUP:
        raise ValueError(f"query group {G} > {MAX_GROUP}")
    page = k_pages.shape[1]
    smem = (4 * page * hd * q.element_size()
            + 4 * (G * hd + G * page + 3 * MAX_GROUP) + 4 * table.shape[1])
    if smem > _SMEM_LIMIT:
        raise ValueError(f"page {page} x group {G} needs {smem} bytes of "
                         f"shared memory, over {_SMEM_LIMIT}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (cp.async tiles)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("table", table), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_attention(q, k_pages, v_pages, table, pos, *, window=None):
    """q: (B, 1, H, hd); k_pages/v_pages: (P, page, K, hd) with H = K*G;
    table: (B, n_pages) int32 (page 0 = scratch); pos: (B,) int32 current
    absolute position per row (its K/V already written). ``window``
    enables ring semantics over the table's W = n_pages*page slots.
    Returns (B, 1, H, hd)."""
    b, sq, h, hd = q.shape
    if sq != 1:
        raise ValueError(f"paged decode takes one query token, got Sq={sq}")
    _, page, kh, hdp = k_pages.shape
    if hdp != hd or h % kh:
        raise ValueError(f"pool heads/dims {(kh, hdp)} do not fit query "
                         f"{(h, hd)} (H must be a multiple of K)")
    n_pages = table.shape[1]
    if window is not None and n_pages * page > window:
        raise ValueError(f"ring of {n_pages}x{page} slots exceeds "
                         f"window={window}")
    if q.device.type != "cuda":
        return paged_attention_ref(q, k_pages, v_pages, table, pos,
                                   window=window)
    G = h // kh
    _check(q, k_pages, v_pages, table, pos, G)
    out = torch.empty_like(q)
    err = _build.launcher(KERNEL, ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, kh, G, hd, page, n_pages, -1 if window is None else int(window),
        1.0 / math.sqrt(hd), DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
