"""Public wrapper: in-kernel paged flash-decode.

Takes the serving decode shapes as they are — q ``(B, 1, H, hd)`` (one
rotated query token per slot), one layer's page pools ``(P, page, K,
hd)``, the slot page tables ``(B, n_pages)`` int32 and the per-row
positions ``(B,)`` int32 — and returns ``(B, 1, H, hd)``. The GQA grouping
(H = K * G, head ``k * G + g``) matches ``models.layers._grouped_scores``.

A CUDA tensor launches ``csrc/paged_attention.cu`` (or raises); a CPU
tensor takes the plain version, ``ref.paged_attention_ref``. The kernel
splits each row's live keys (tiles of ``KEY_TILE`` slots) over
``paged_splits`` blocks and adds their fp32 partials in split order in a
second kernel behind the same entry point; the wrapper allocates that
scratch and never reads ``pos`` on the host. Every call adds one to
``paged_attention.launches``.
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
KEY_TILE = 16                  # slots per key tile (the kernel's kKT)
SPLIT_TARGET_BLOCKS = 2 * 132  # two blocks per SM of an H100 at a full table
MAX_SPLITS = 32                # the combine's shared-memory slots
_SMEM_LIMIT = 232448           # shared memory a block may use on sm_90

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``paged_attention_launch``'s C signature, in order
ARGTYPES = [_P] * 7 + [_I] * 8 + [ctypes.c_float, _I, _I, _P]


def paged_splits(b: int, kh: int, n_pages: int, page: int) -> int:
    """Blocks each (row, kv head) is split over: enough that a full table
    fills the card, each taking an equal share of its key tiles. Depends on
    the shapes alone (the kernel cuts each row's live tiles by the same
    count from ``pos``), so a run gives the same bits as the last one."""
    tiles = math.ceil(n_pages * page / KEY_TILE)
    want = min(MAX_SPLITS, math.ceil(SPLIT_TARGET_BLOCKS / (b * kh)))
    per = math.ceil(tiles / want)
    return math.ceil(tiles / per)


def smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared memory of one split block, as the kernel sizes it.
    bf16: the q tile and a 2-stage ring of 64 K and 64 V slot rows, padded
    by 16 bytes (reused for the four warps' states once drained); fp32: 2
    stages of 16 K and V rows, the q rows, the scores and m / l / alpha."""
    if dtype == torch.bfloat16:
        ring = 2 * (KEY_TILE + 2 * 2 * 4 * KEY_TILE) * (hd + 8)
        merge = 4 * 4 * MAX_GROUP * (hd + 2)
        return max(ring, merge)
    return 4 * (4 * KEY_TILE * hd + MAX_GROUP * hd + MAX_GROUP * KEY_TILE
                + 3 * MAX_GROUP)


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
    smem = smem_bytes(q.dtype, hd)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"head_dim {hd} needs {smem} bytes of shared "
                         f"memory, over {_SMEM_LIMIT}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (cp.async "
                             "rows)")
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
    splits = paged_splits(b, kh, n_pages, page)
    out = torch.empty_like(q)
    part = torch.empty(b * kh * splits * G * (hd + 2), dtype=torch.float32,
                       device=q.device)
    err = _build.launcher(KERNEL, ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(), part.data_ptr(),
        b, kh, G, hd, page, n_pages, -1 if window is None else int(window),
        splits, 1.0 / math.sqrt(hd), DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
