"""Backward pass of the lowering conv (paper §III applied to backprop; the
JAX package's ``kernels/lowering_conv/bwd.py``).

The plain versions are GEMMs over the *same* lowered patch matrix the
forward already built:

  wgrad   dW_hat = lowered(x)^T @ dY_hat          one (K, M) x (M, Cout) GEMM
  dgrad   dCols  = dY_hat @ K_hat^T               one (M, Cout) x (Cout, K) GEMM
          dX     = col2im(dCols)                  the K = kh*kw*Cin patch
                                                  columns added back to pixels

Plain versions (``wgrad_ref``, ``col2im_ref``, ``dgrad_ref``: the JAX
``*_xla`` forms) and the wrappers of the two kernels, both 3xTF32 on
Hopper's wgmma: ``wgrad_cuda`` (``csrc/wgrad.cu``: dY split into TF32 big
and small halves and transposed by a prologue, then partial products over
slices of the M rows with both tiles brought by TMA, then a sum in slice
order) and ``dgrad_cuda`` (``csrc/dgrad.cu``: dX as one implicit GEMM over
the taps, W split into TF32 big and small halves by a prologue and brought
by TMA, dY gathered on the fly; no dCols, no col2im pass).
A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version. Each wrapper call adds one to its ``launches``.

``ConvTiles`` holds the three kernels' tiles (the forward's, wgrad's and
dgrad's widths, and the number of blocks wgrad's split over M aims at);
``default_tiles`` is the fixed rule every layer ran before the autotuner
(``autotune``) and still runs unless it was probed.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lowering_conv.lowering_conv import (
    BLOCK_N, check_operands, dgrad_block_n, out_block_n, out_hw,
    split_stages)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``wgrad_launch``'s C signature, in order
WGRAD_ARGTYPES = [_P] * 5 + [_I] * 7 + [_P]
#: ``dgrad_launch``'s C signature, in order
DGRAD_ARGTYPES = [_P] * 4 + [_I] * 10 + [_P]

WGRAD_TILE_K = 128             # rows of dW (K) per wgrad block
WGRAD_STAGE_ROWS = 32          # reduction rows of one wgrad stage
WGRAD_MAX_SLICE_ROWS = 2048    # rows one block sums in order (fp32 error)
WGRAD_TARGET_BLOCKS = 3 * 132  # three waves of one block an SM of an H100


@dataclasses.dataclass(frozen=True)
class ConvTiles:
    """The tiles of one layer's three kernels: the forward's width in
    output channels (B2), wgrad's width in output channels and the blocks
    its split over M aims at (B3; the slices are derived from M at each
    call, ``wgrad_slices``), dgrad's width in input channels (B4)."""
    fwd_bn: int
    wgrad_bn: int
    wgrad_blocks: int
    dgrad_bn: int

    def __post_init__(self):
        for name in ("fwd_bn", "wgrad_bn", "dgrad_bn"):
            if getattr(self, name) not in BLOCK_N:
                raise ValueError(f"{name}={getattr(self, name)}: the kernels "
                                 f"are built for widths {BLOCK_N}")
        if self.wgrad_blocks < 1:
            raise ValueError(f"wgrad_blocks={self.wgrad_blocks} < 1")


def default_tiles(w_shape) -> ConvTiles:
    """The fixed rule for kernel shape (kh, kw, Cin, Cout): the forward's
    and wgrad's width the one that takes the fewest tiles of Cout
    (``out_block_n``), dgrad's the one that pads Cin least
    (``dgrad_block_n``), wgrad aiming at ``WGRAD_TARGET_BLOCKS``."""
    bn_out = out_block_n(w_shape[3])
    return ConvTiles(fwd_bn=bn_out, wgrad_bn=bn_out,
                     wgrad_blocks=WGRAD_TARGET_BLOCKS,
                     dgrad_bn=dgrad_block_n(w_shape[2]))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def wgrad_ref(lowered: torch.Tensor, dy: torch.Tensor, kshape) -> torch.Tensor:
    """lowered: (M, kh*kw*Cin) or (B, Ho, Wo, kh*kw*Cin) forward residual;
    dy: (..., Cout) cotangent. Returns dW (kh, kw, Cin, Cout) via one GEMM —
    no re-lowering."""
    kh, kw, cin, cout = kshape
    low = lowered.reshape(-1, kh * kw * cin)
    return (low.T @ dy.reshape(-1, cout)).reshape(kh, kw, cin, cout)


def _col2im_accumulate(g: torch.Tensor, h: int, w: int, kh: int, kw: int,
                       stride: int) -> torch.Tensor:
    """Add patch-column gradients g (B, Ho, Wo, kh*kw, Cin) onto a
    (B, H, W, Cin) grid, one tap (i, j) at a time in order — the JAX
    interior-padded adds, with the zero terms left out."""
    b, ho, wo, _, cin = g.shape
    dx = torch.zeros((b, h, w, cin), dtype=g.dtype, device=g.device)
    idx = 0
    for i in range(kh):
        for j in range(kw):
            dx[:, i:i + (ho - 1) * stride + 1:stride,
               j:j + (wo - 1) * stride + 1:stride, :] += g[:, :, :, idx, :]
            idx += 1
    return dx


def col2im_ref(dcols: torch.Tensor, x_shape, kh: int, kw: int,
               stride: int) -> torch.Tensor:
    """Patch-column gradients (B*Ho*Wo, kh*kw*Cin) back onto the image
    grid (the lifting phase transposed)."""
    b, h, w, cin = x_shape
    ho, wo = out_hw(h, w, kh, kw, stride)
    g = dcols.reshape(b, ho, wo, kh * kw, cin)
    return _col2im_accumulate(g, h, w, kh, kw, stride)


def dgrad_ref(dy: torch.Tensor, w: torch.Tensor, x_shape,
              stride: int) -> torch.Tensor:
    """dX via one GEMM against the kernel matrix, then col2im."""
    kh, kw, cin, cout = w.shape
    dcols = dy.reshape(-1, cout) @ w.reshape(kh * kw * cin, cout).T
    return col2im_ref(dcols, x_shape, kh, kw, stride)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def wgrad_slices(m: int, k: int, cout: int, block_n: int = None,
                 target_blocks: int = WGRAD_TARGET_BLOCKS):
    """(slice_rows, slices) of the split over the M rows: about
    ``target_blocks`` blocks over the dW tiles (128 x ``block_n``, default
    ``out_block_n(cout)``), at most ``WGRAD_MAX_SLICE_ROWS`` rows summed
    in order by any one block (an fp32 accuracy bound, whatever the tiles),
    slices a whole number of 32-row stages. Depends on the shapes and tiles
    only, so a run gives the same bits as the last one."""
    block_n = out_block_n(cout) if block_n is None else block_n
    tiles = math.ceil(k / WGRAD_TILE_K) * math.ceil(cout / block_n)
    per, slices = split_stages(
        math.ceil(m / WGRAD_STAGE_ROWS), tiles, target_blocks,
        least=math.ceil(m / WGRAD_MAX_SLICE_ROWS))
    return per * WGRAD_STAGE_ROWS, slices


def wgrad_split_floats(m: int, cout: int) -> int:
    """Floats of wgrad's dY scratch: big and small halves of dY
    transposed, (Cout, M4) each, M4 = M rounded up to 4 (16-byte rows, as
    TMA reads them)."""
    return 2 * cout * (-(-m // 4) * 4)


def wgrad_cuda(lowered: torch.Tensor, dy: torch.Tensor, kshape, *,
               tiles: ConvTiles = None) -> torch.Tensor:
    """lowered: (B, Ho, Wo, kh*kw*Cin) forward residual (or (M, K));
    dy: (B, Ho, Wo, Cout). Returns dW (kh, kw, Cin, Cout) in fp32, split
    over M by ``tiles`` (``wgrad_bn``, ``wgrad_blocks``; default
    ``default_tiles(kshape)``). The kernel's prologue writes dY's TF32 big
    and small halves, transposed, to a scratch of
    ``wgrad_split_floats(M, Cout)`` floats."""
    kh, kw, cin, cout = kshape
    K = kh * kw * cin
    if lowered.shape[-1] != K or dy.shape[-1] != cout:
        raise ValueError(f"lowered {tuple(lowered.shape)} / dy "
                         f"{tuple(dy.shape)} do not fit kernel {tuple(kshape)}")
    m = lowered.numel() // K
    if dy.numel() != m * cout:
        raise ValueError(f"dy has {dy.numel() // cout} rows, lowered {m}")
    if lowered.device.type != "cuda":
        return wgrad_ref(lowered, dy, kshape)
    check_operands(lowered=lowered, dy=dy)
    t = default_tiles(kshape) if tiles is None else tiles
    rows, slices = wgrad_slices(m, K, cout, t.wgrad_bn, t.wgrad_blocks)
    dysplit = torch.empty(wgrad_split_floats(m, cout), dtype=torch.float32,
                          device=lowered.device)
    part = torch.empty((slices, K, cout), dtype=torch.float32,
                       device=lowered.device)
    dw = torch.empty((kh, kw, cin, cout), dtype=torch.float32,
                     device=lowered.device)
    err = _build.launcher("wgrad", WGRAD_ARGTYPES)(
        lowered.data_ptr(), dy.data_ptr(), dysplit.data_ptr(),
        part.data_ptr(), dw.data_ptr(), m,
        K, cout, rows, slices, t.wgrad_bn,
        lowered.device.index or 0,
        torch.cuda.current_stream(lowered.device).cuda_stream)
    _build.check(err, "wgrad")
    wgrad_cuda.launches += 1
    return dw


wgrad_cuda.launches = 0


def dgrad_split_floats(w_shape) -> int:
    """Floats of dgrad's W scratch: big and small halves of W as
    (kh*kw*Cin, Cout4) each, Cout4 = Cout rounded up to 4 (16-byte rows,
    as TMA reads them)."""
    kh, kw, cin, cout = w_shape
    return 2 * kh * kw * cin * (-(-cout // 4) * 4)


def dgrad_cuda(dy: torch.Tensor, w: torch.Tensor, x_shape, *,
               stride: int = 1, tiles: ConvTiles = None) -> torch.Tensor:
    """dy: (B, Ho, Wo, Cout); w: (kh, kw, Cin, Cout). Returns dX of
    ``x_shape`` (B, H, W, Cin) in fp32, written once by the kernel, in
    tiles ``tiles.dgrad_bn`` input channels wide (default
    ``dgrad_block_n(Cin)``). The kernel's prologue writes W's TF32 big and
    small halves to a scratch of ``dgrad_split_floats(w.shape)`` floats."""
    b, h, wd, cin = x_shape
    kh, kw, cin_w, cout = w.shape
    ho, wo = out_hw(h, wd, kh, kw, stride)
    if cin_w != cin or tuple(dy.shape) != (b, ho, wo, cout):
        raise ValueError(f"dy {tuple(dy.shape)} / w {tuple(w.shape)} do not "
                         f"fit x {tuple(x_shape)} at stride {stride}")
    if dy.device.type != "cuda":
        return dgrad_ref(dy, w, x_shape, stride)
    check_operands(dy=dy, w=w)
    dx = torch.empty(tuple(x_shape), dtype=torch.float32, device=dy.device)
    wsplit = torch.empty(dgrad_split_floats(w.shape), dtype=torch.float32,
                         device=dy.device)
    err = _build.launcher("dgrad", DGRAD_ARGTYPES)(
        dy.data_ptr(), w.data_ptr(), wsplit.data_ptr(), dx.data_ptr(), b, h,
        wd, cin, kh, kw, stride, cout,
        dgrad_block_n(cin) if tiles is None else tiles.dgrad_bn,
        dy.device.index or 0,
        torch.cuda.current_stream(dy.device).cuda_stream)
    _build.check(err, "dgrad")
    dgrad_cuda.launches += 1
    return dx


dgrad_cuda.launches = 0
