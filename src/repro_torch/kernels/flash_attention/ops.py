"""Public wrapper: GQA-aware forward flash attention.

q ``(B, Sq, H, hd)``, k/v ``(B, Sk, K, hd)`` with H = K*G, read in place
(no transposes, K/V never repeated: query head ``h`` reads kv head
``h // G``); optional ``q_offsets`` ``(B,)`` int32 give each row's first
query its absolute position. Returns ``(B, Sq, H, hd)``.

A CUDA tensor launches ``csrc/flash_attention.cu`` (or raises); a CPU
tensor takes the plain version, ``ref.flash_attention_ref``. Every launch
adds one to ``flash_attention.launches``. ``smem_bytes`` is the shared
memory a block of the kernel asks for, the figure the kernel exports
(``kernel_smem_bytes``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

KERNEL = "flash_attention"
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_Y = 65535

# the bf16 kernel's tiles (csrc ``wg::Tile``): 128 query rows a block (two
# warpgroups of 64)
BF16_QUERY_TILE = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``flash_attention_launch``'s C signature, in order
ARGTYPES = [_P] * 5 + [_I] * 8 + [ctypes.c_float, _I, _I, _P]


def bf16_key_tile(hd: int) -> int:
    """Keys a tile of the bf16 kernel takes: 128, or 64 at hd 256, where
    the O accumulator fills the registers."""
    return 64 if hd == 256 else 128


def bf16_stages(hd: int) -> int:
    """Depth of the bf16 kernel's K/V ring: 3, or 2 at hd 256 (a third
    stage of 64 keys would not fit beside the 64 KB Q tile)."""
    return 2 if hd == 256 else 3


def smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared memory one block asks for. bf16: 1024 bytes of
    alignment slack, the Q tile, K and V tiles for each ring stage,
    8-byte mbarriers (Q full; K full and V full a stage) and a 4-byte count
    of the warps done with each stage's K and with its V. fp32: the padded
    Q, K, V and score tiles and three row vectors."""
    if dtype == torch.bfloat16:
        bk, st = bf16_key_tile(hd), bf16_stages(hd)
        return (1024 + 2 * hd * (BF16_QUERY_TILE + 2 * st * bk)
                + 8 * (1 + 2 * st) + 4 * 2 * st)
    if dtype == torch.float32:
        return 4 * (64 * (hd + 1) + 32 * (hd + 1) + 32 * hd + 64 * 33 + 3 * 64)
    raise TypeError(f"dtype {dtype} not in {tuple(DTYPES)}")


def kernel_smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """The compiled kernel's own figure, ``flash_attention_smem_bytes``
    (builds the kernel if needed; a host call, no launch)."""
    fn = _build.load(KERNEL).flash_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(hd, DTYPES.get(dtype, -1))


def _check(q, k, v, q_offsets) -> None:
    dev = q.device
    for name, t in (("k", k), ("v", v), ("q_offsets", q_offsets)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {tuple(DTYPES)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k/v dtypes {k.dtype}/{v.dtype} != q {q.dtype}")
    b, _, h, hd = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid's {MAX_GRID_Y}")
    if q_offsets is not None and (q_offsets.dtype != torch.int32
                                  or q_offsets.shape != (b,)):
        raise TypeError("q_offsets must be (B,) int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_offsets", q_offsets)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offsets=None):
    """q: (B, Sq, H, hd); k,v: (B, Sk, K, hd) with H = K*G. ``q_offsets``:
    optional (B,) int32 absolute position of each batch row's first query.
    Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    if h % kh:
        raise ValueError(f"H={h} must be a multiple of K={kh}")
    if q.device.type != "cuda":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offsets=q_offsets)
    _check(q, k, v, q_offsets)
    out = torch.empty_like(q)
    err = _build.launcher(KERNEL, ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if q_offsets is None else q_offsets.data_ptr(), out.data_ptr(),
        b, h, kh, sq, k.shape[1], hd, int(bool(causal)),
        -1 if window is None else int(window), 1.0 / math.sqrt(hd),
        DTYPES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
