"""Public wrapper: in-kernel paged flash-decode.

Takes the serving decode shapes as they are — q ``(B, 1, H, hd)`` (one
rotated query token per slot), one layer's page pools ``(P, page, K,
hd)``, the slot page tables ``(B, n_pages)`` int32 and the per-row
positions ``(B,)`` int32 — and returns ``(B, 1, H, hd)``. The GQA grouping
(H = K * G, head ``k * G + g``) matches ``models.layers._grouped_scores``.

A CUDA tensor launches ``csrc/paged_attention.cu`` (or raises); a CPU
tensor takes the plain version, ``ref.paged_attention_ref``. One launch a
call: the kernel splits each row's live keys (tiles of ``KEY_TILE``
slots) over ``paged_splits`` blocks, which form one thread-block cluster
and add their fp32 states in split order through each other's shared
memory; the wrapper allocates no scratch and never reads ``pos`` on the
host. Every call adds one to ``paged_attention.launches``.
``smem_bytes`` is the shared memory a block asks for, the figure the
kernel exports (``kernel_smem_bytes``).
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
KEY_TILE = 64                  # slots of a key tile, a split's unit (kTile)
F32_TILE = 16                  # slots of the fp32 kernel's tiles (kF32Tile)
#: blocks a call aims at: one an SM of an H100. (Clusters of 8 bf16 blocks
#: of 92,304 bytes fit only 30 at once on the card, so the 32 (row, kv
#: head)s of the serving shapes at two blocks an SM would take a second
#: wave: phase 4 of chip_smoke.py prints both.)
SPLIT_TARGET_BLOCKS = 132
MAX_SPLITS = 8                 # a cluster's blocks: the portable cluster size
MAX_STAGES = 8                 # the bf16 kernel's ring depth at most
_SMEM_LIMIT = 232448           # shared memory a block may use on sm_90
#: the bf16 kernel's shared memory a block: two blocks an SM (228 KB less
#: 1 KB reserved a block, halved)
BLOCK_BUDGET = (233472 - 2 * 1024) // 2

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``paged_attention_launch``'s C signature, in order
ARGTYPES = [_P] * 6 + [_I] * 9 + [ctypes.c_float, _I, _I, _P]


def paged_splits(b: int, kh: int, n_pages: int, page: int) -> int:
    """Blocks each (row, kv head) is split over (one cluster): enough that
    a full table fills the card's SMs, each taking an equal share of its
    key tiles, at most ``MAX_SPLITS``. Depends on the shapes alone (the
    kernel cuts each row's live tiles by the same count from ``pos``), so
    a run gives the same bits as the last one."""
    tiles = math.ceil(n_pages * page / KEY_TILE)
    want = min(MAX_SPLITS, math.ceil(SPLIT_TARGET_BLOCKS / (b * kh)))
    per = math.ceil(tiles / want)
    return math.ceil(tiles / per)


def inbox_bytes(hd: int) -> int:
    """A block's inbox for the cluster's combine (fp32): (m, l) of every
    row of every split, then every split's part of the block's slice of
    the outputs (``MAX_GROUP * hd`` floats and a float4 a split of
    rounding)."""
    return 4 * (2 * MAX_SPLITS * MAX_GROUP + MAX_GROUP * hd + 4 * MAX_SPLITS)


def bf16_stages(hd: int) -> int:
    """Key tiles the bf16 kernel's ring holds: as many as fit beside the Q
    tile and the inbox in ``BLOCK_BUDGET``, at most ``MAX_STAGES`` (2 at
    hd 128)."""
    fixed = 1024 + 128 * hd + inbox_bytes(hd)
    return min(MAX_STAGES, (BLOCK_BUDGET - fixed) // (256 * hd + 8))


def smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared memory of one block, as the kernel sizes it. bf16:
    1024 bytes of alignment slack, the 64-row Q tile, K and V tiles of 64
    slots for each ring stage, the inbox, an 8-byte mbarrier a stage; fp32:
    2 stages of 16 K and V rows, the q rows, the scores, alpha, m and l,
    then the inbox."""
    if dtype == torch.bfloat16:
        return (1024 + 128 * hd + inbox_bytes(hd)
                + bf16_stages(hd) * (256 * hd + 8))
    if dtype == torch.float32:
        return 4 * (4 * F32_TILE * hd + MAX_GROUP * hd
                    + MAX_GROUP * F32_TILE + 3 * MAX_GROUP) + inbox_bytes(hd)
    raise TypeError(f"dtype {dtype} not in {tuple(DTYPES)}")


def kernel_smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """The compiled kernel's own figure, ``paged_attention_smem_bytes``
    (builds the kernel if needed; a host call, no launch)."""
    fn = _build.load(KERNEL).paged_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(hd, DTYPES.get(dtype, -1))


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
            raise ValueError(f"{name} must be 16-byte aligned (TMA and "
                             "16-byte copies)")
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
    err = _build.launcher(KERNEL, ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, kh, G, hd, page,
        n_pages, k_pages.shape[0], -1 if window is None else int(window),
        splits, 1.0 / math.sqrt(hd), DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
