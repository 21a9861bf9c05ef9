"""The lowering-conv forward kernel's wrapper (``lowering_conv_cuda``), the
shared-memory footprint model of the three conv kernels (``smem_bytes``),
the tile-width rule, and the tile arithmetic the JAX package exposes with
them.

``csrc/lowering_conv.cu`` is an implicit GEMM in 3xTF32 (fp32 accuracy) on
Hopper's wgmma: a prologue splits the (kh*kw*Cin, Cout) kernel matrix once
into TF32 big and small halves, transposed into a scratch of
``fwd_split_floats(w.shape)`` floats that TMA reads; each block gathers the
image patches of its 128 output rows into shared memory, 32 columns at a
time through a 4-stage ring, and never writes the lowered matrix to device
memory except as the backward's residual (``return_lowered``, stored from
the gathered stages). A layer with few output tiles is also split over K
(``fwd_k_slices``), its slices' partials summed in slice order. A tile is
128 rows by ``block_n`` output channels, 64 or 96 (``BLOCK_N``, the widths
of all three conv kernels): by default the one that takes the fewest tiles
(``out_block_n``), or the autotuner's pick (``autotune``, through
``bwd.ConvTiles``). ``smem_bytes`` is the dynamic shared memory each
kernel asks for at a width, the counterpart of the JAX ``vmem_bytes``;
each kernel exports its own value (``<kernel>_smem_bytes``) so the model
is held to the compiled code on the card (``kernel_smem_bytes``). ``largest_divisor`` and
``choose_tiles`` are the TPU kernel's (b_p, r_b) tile resolution, kept for
the callers that report it.

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
ARGTYPES = [_P] * 6 + [_I] * 12 + [_P]
#: tile widths in channels (forward and wgrad: Cout; dgrad: Cin)
BLOCK_N = (64, 96)
#: each pass's kernel (``csrc/<name>.cu``)
PASS_KERNELS = {"fwd": KERNEL, "wgrad": "wgrad", "dgrad": "dgrad"}
RING_STAGES = 4            # every conv kernel's ring of stages
BLOCK_M = 128              # rows of a tile (pixels; wgrad: rows of dW), two
                           # consumer warpgroups of 64
STAGE_K = 32               # fp32 columns of a stage's A row (the forward: of K)
STAGE_BYTES_A = BLOCK_M * STAGE_K * 4
SMS = 132                  # streaming multiprocessors of an H100
FWD_MAX_K_SLICES = 8       # the forward's split over K: partials it writes


def dgrad_block_n(c: int) -> int:
    """dgrad's tile width in input channels by default: the one of
    ``BLOCK_N`` that pads c least, the wider on a tie (96 channels
    fill one tile; 256 take four of 64, 384 four of 96)."""
    return min(BLOCK_N, key=lambda n: (math.ceil(c / n) * n, -n))


def out_block_n(c: int) -> int:
    """The forward's and wgrad's tile width in output channels by default:
    the one of ``BLOCK_N`` that takes the fewest tiles, the narrower
    on a tie (96 for CaffeNet's 96, 256 and 384: each tile re-reads the
    whole A operand, the gathered patches or the residual, so fewer tiles
    beat less padding)."""
    return min(BLOCK_N, key=lambda n: (math.ceil(c / n), n))


def smem_bytes(*, pass_: str, block_n: int) -> int:
    """Dynamic shared memory one block of ``pass_``'s kernel asks for at
    tile width ``block_n`` (the ``smem_bytes<BN>()`` of the kernel's
    source). The counterpart of the JAX ``vmem_bytes``; on the card a
    block's footprint does not depend on the layer's shape.

    The three kernels share one ring layout: ``RING_STAGES`` stages, each
    an A tile of ``BLOCK_M`` rows x ``STAGE_K`` fp32 columns (forward:
    pixels x K,
    gathered from x; wgrad: rows of dW x reduction rows of the residual;
    dgrad: pixels x output channels of dY) and the B tile's TF32 big and
    small halves, ``block_n`` rows of 32 fp32 each (W for the forward and
    dgrad, dY for wgrad); plus 1024 bytes of slack that align the ring to
    the 128-byte swizzle and two 8-byte mbarriers a stage (full, empty).

    pass_: "fwd" | "wgrad" | "dgrad"
    """
    if block_n not in BLOCK_N:
        raise ValueError(f"block_n {block_n}: the kernels are built for "
                         f"{BLOCK_N}")
    if pass_ not in PASS_KERNELS:
        raise ValueError(f"unknown pass_ {pass_!r} "
                         "(expected fwd | wgrad | dgrad)")
    return (1024 + RING_STAGES * (STAGE_BYTES_A + 2 * block_n * STAGE_K * 4)
            + 16 * RING_STAGES)


def split_stages(n_stages: int, tiles: int, target_blocks: int,
                 least: int = 1, most: int = None):
    """(stages a slice, slices) of a reduction of ``n_stages`` stages split
    so that ``tiles`` x slices reaches ``target_blocks``: the slices
    ceil(target / tiles), at least ``least``, at most ``most`` and
    ``n_stages``, each a whole number of stages, none empty. The rule of
    both splits (the forward's over K, ``fwd_k_slices``; wgrad's over M,
    ``bwd.wgrad_slices``); it depends on its arguments only, so a run gives
    the same bits as the last one."""
    s = max(least, math.ceil(target_blocks / tiles))
    s = min(s, n_stages if most is None else min(most, n_stages))
    per = math.ceil(n_stages / s)
    return per, math.ceil(n_stages / per)


def fwd_k_slices(m: int, k: int, cout: int, block_n: int):
    """(slice_stages, slices) of the forward's split over K: the 32-column
    stages cut into ``slices`` runs of ``slice_stages``, each a block of
    its own whose partial (M, Cout) sum the kernel adds to the others in
    slice order. A layer whose 128 x ``block_n`` tiles leave the card's
    ``SMS`` SMs idle (CaffeNet's conv4 and conv5 at group batch 64: 100
    and 39 tiles) is split until its blocks fill them, into at most
    ``FWD_MAX_K_SLICES`` slices (``split_stages``)."""
    tiles = math.ceil(m / BLOCK_M) * math.ceil(cout / block_n)
    return split_stages(math.ceil(k / STAGE_K), tiles, SMS,
                        most=FWD_MAX_K_SLICES)


def fwd_split_floats(w_shape) -> int:
    """Floats of the forward's W scratch: big and small halves of W
    transposed, (Cout, K4) each, K4 = kh*kw*Cin rounded up to 4 (16-byte
    rows, as TMA reads them)."""
    kh, kw, cin, cout = w_shape
    return 2 * cout * (-(-(kh * kw * cin) // 4) * 4)


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
    default ``out_block_n(Cout)``. The kernel's prologue writes W's TF32
    big and small halves, transposed, to a scratch of
    ``fwd_split_floats(w.shape)`` floats; where ``fwd_k_slices`` splits K,
    the slices' partials go to an (S, M, Cout) scratch and are summed in
    slice order."""
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
    wsplit = torch.empty(fwd_split_floats(w.shape), dtype=torch.float32,
                         device=x.device)
    bn = out_block_n(cout) if tiles is None else tiles.fwd_bn
    per, slices = fwd_k_slices(b * ho * wo, kh * kw * cin, cout, bn)
    part = (torch.empty((slices, b * ho * wo, cout), dtype=torch.float32,
                        device=x.device) if slices > 1 else None)
    err = _build.launcher(KERNEL, ARGTYPES)(
        x.data_ptr(), w.data_ptr(), wsplit.data_ptr(),
        None if part is None else part.data_ptr(), y.data_ptr(),
        None if low is None else low.data_ptr(), b, h, wd, cin, kh, kw,
        stride, cout, bn, per, slices, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, KERNEL)
    lowering_conv_cuda.launches += 1
    return (y, low) if return_lowered else y


lowering_conv_cuda.launches = 0
