"""The lowering-conv forward kernel's wrapper (``lowering_conv_cuda``), the
shared-memory footprint model of the three conv kernels (``smem_bytes``),
the tile-width rule, and the tile arithmetic the JAX package exposes with
them.

``csrc/lowering_conv.cu`` is an implicit GEMM on TF32 tensor cores in
3xTF32 (fp32 accuracy): each block gathers the image patches of its 64
output rows into shared memory, 32 columns of the (kh*kw*Cin, Cout) kernel
matrix at a time through a 3-stage ``cp.async`` ring, and never writes the
lowered matrix to device memory except as the backward's residual
(``return_lowered``, copied from the gathered stages). A tile is 64 rows by
``block_n`` output channels, 64 or 96 (``DGRAD_BLOCK_N``): by default the
one that pads Cout least (``dgrad_block_n``), or the autotuner's pick
(``autotune``, through ``bwd.ConvTiles``). ``smem_bytes`` is the
dynamic shared memory each kernel asks for at a width, the counterpart of
the JAX ``vmem_bytes``; each kernel exports its own value
(``<kernel>_smem_bytes``) so the model is held to the compiled code on the
card (``kernel_smem_bytes``). ``largest_divisor`` and ``choose_tiles`` are
the TPU kernel's (b_p, r_b) tile resolution, kept for the callers that
report it.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version (``ref.lower`` + ``ref.lowered_conv_ref``). Every launch adds
one to ``lowering_conv_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowering_conv.ref import lower

KERNEL = "lowering_conv"

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``lowering_conv_launch``'s C signature, in order
ARGTYPES = [_P] * 4 + [_I] * 10 + [_P]
#: tile widths in channels (forward and wgrad: Cout; dgrad: Cin)
DGRAD_BLOCK_N = (64, 96)
#: each pass's kernel (``csrc/<name>.cu``)
PASS_KERNELS = {"fwd": KERNEL, "wgrad": "wgrad", "dgrad": "dgrad"}
SMEM_STAGES = 3            # the forward's and wgrad's cp.async rings
DGRAD_STAGES = 4           # dgrad's ring (TMA for W, cp.async for dY)
DGRAD_BLOCK_M = 128        # pixels of a dgrad tile: two consumer warpgroups


def dgrad_block_n(c: int) -> int:
    """A tile's width in channels (forward and wgrad: output channels;
    dgrad: input channels) by default: the one of ``DGRAD_BLOCK_N`` that
    pads c least, the wider on a tie (96 channels fill one tile; 256 take
    four of 64, 384 four of 96)."""
    return min(DGRAD_BLOCK_N, key=lambda n: (math.ceil(c / n) * n, -n))


def smem_bytes(*, pass_: str, block_n: int) -> int:
    """Dynamic shared memory one block of ``pass_``'s kernel asks for at
    tile width ``block_n`` (the ``smem_bytes<BN>()`` of the kernel's
    source). The counterpart of the JAX ``vmem_bytes``; on the card a
    block's footprint does not depend on the layer's shape.

    pass_:
      "fwd"    ``SMEM_STAGES`` stages, rows padded against bank conflicts.
               A: 64 pixels x (32 + 4) columns gathered from x; B: 32 rows
               of K-hat x (BN + 8)
      "wgrad"  ``SMEM_STAGES`` stages. A: 32 rows of the residual x
               (64 + 8); B: 32 rows of dY x (BN + 8)
      "dgrad"  ``DGRAD_STAGES`` stages of 128-byte swizzled rows (32
               channels), unpadded. A: ``DGRAD_BLOCK_M`` pixels of dY; B:
               BN input channels of W's big and of its small half; plus
               1024 bytes of slack that align the ring to the swizzle and
               two 8-byte mbarriers a stage (full, empty)
    """
    if block_n not in DGRAD_BLOCK_N:
        raise ValueError(f"block_n {block_n}: the kernels are built for "
                         f"{DGRAD_BLOCK_N}")
    if pass_ == "fwd":
        floats = 64 * 36 + 32 * (block_n + 8)
    elif pass_ == "wgrad":
        floats = 32 * (64 + 8 + block_n + 8)
    elif pass_ == "dgrad":
        return (1024 + DGRAD_STAGES * (DGRAD_BLOCK_M + 2 * block_n) * 32 * 4
                + 16 * DGRAD_STAGES)
    else:
        raise ValueError(f"unknown pass_ {pass_!r} "
                         "(expected fwd | wgrad | dgrad)")
    return SMEM_STAGES * floats * 4


def kernel_smem_bytes(pass_: str, block_n: int) -> int:
    """The compiled kernel's own figure, ``<kernel>_smem_bytes(block_n)``
    (builds the kernel if needed; a host call, no launch)."""
    fn = getattr(_build.load(PASS_KERNELS[pass_]),
                 f"{PASS_KERNELS[pass_]}_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(block_n)


def largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (>= 1). O(sqrt n) via divisor
    pairs instead of decrement-by-1 probing."""
    cap = max(1, min(cap, n))
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            if d <= cap:
                best = max(best, d)
            if n // d <= cap:
                best = max(best, n // d)
        d += 1
    return best


def choose_tiles(b: int, ho: int, bp: int, rb: int) -> tuple:
    """Resolve requested (b_p, r_b) to the tile sizes the TPU kernel runs:
    the largest divisors of the batch / output-rows not exceeding the
    request."""
    return largest_divisor(b, bp), largest_divisor(ho, rb)


def check_operands(**tensors) -> None:
    """fp32, contiguous, all on the first tensor's device (the three conv
    kernels take nothing else)."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}: the conv kernels run "
                            "in fp32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def out_hw(h: int, w: int, kh: int, kw: int, stride: int):
    if stride < 1 or kh > h or kw > w:
        raise ValueError(f"a {kh}x{kw} stride-{stride} VALID conv does not "
                         f"fit a {h}x{w} image")
    return (h - kh) // stride + 1, (w - kw) // stride + 1


def lowering_conv_cuda(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                       return_lowered: bool = False, tiles=None):
    """x: (B,H,W,Cin); w: (kh,kw,Cin,Cout); VALID padding. Returns y
    (B,Ho,Wo,Cout), and with ``return_lowered`` also the lowered patch
    matrix (B,Ho,Wo,kh*kw*Cin), the residual the backward reuses.
    ``tiles`` (a ``bwd.ConvTiles``) gives the tile width ``fwd_bn``;
    default ``dgrad_block_n(Cout)``."""
    b, h, wd, cin = x.shape
    kh, kw, cin_w, cout = w.shape
    if cin_w != cin:
        raise ValueError(f"w has {cin_w} input channels, x {cin}")
    ho, wo = out_hw(h, wd, kh, kw, stride)
    if x.device.type != "cuda":
        low = lower(x, kh, kw, stride)
        y = (low @ w.reshape(kh * kw * cin, cout)).reshape(b, ho, wo, cout)
        return (y, low.reshape(b, ho, wo, -1)) if return_lowered else y
    check_operands(x=x, w=w)
    y = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    low = (torch.empty((b, ho, wo, kh * kw * cin), dtype=x.dtype,
                       device=x.device) if return_lowered else None)
    err = _build.launcher(KERNEL, ARGTYPES)(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        None if low is None else low.data_ptr(), b, h, wd, cin, kh, kw,
        stride, cout, dgrad_block_n(cout) if tiles is None else tiles.fwd_bn,
        x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, KERNEL)
    lowering_conv_cuda.launches += 1
    return (y, low) if return_lowered else y


lowering_conv_cuda.launches = 0
