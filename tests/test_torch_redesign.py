"""The arithmetic of the redesigned kernels, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold them to their plain versions there). This file pins
what their designs compute, with oracles written here in plain PyTorch,
on numpy-seeded inputs, against the JAX package:

- **dgrad** (``csrc/dgrad.cu``): dX as one implicit GEMM over the taps in
  the kernel's order ((i, j) outer, Cout in stages of 32, each stage summed
  apart and then added), against JAX ``dgrad_xla`` and
  ``dgrad_pallas(..., interpret=True)`` at strides 1, 2 and 4 with ragged
  Cin and Cout (1e-5 of the output's scale: fp32 sums in another order);
  then the same product in 3xTF32 (big = TF32(x) rounded to nearest and
  small = x - big truncated to TF32, both by bit masking; big*small +
  small*big + big*big) within 1e-5 relative RMS of ``dgrad_xla`` at
  CaffeNet's conv2-5 kernel shapes (reduced batch and image), while one
  TF32 product misses that limit. The wgmma kernel's order: the rows in
  blocks of 64 or 128 pixels, each stage's three products taken step by
  step over its four 8-channel steps (big*small, small*big, big*big), in
  fp32 against ``dgrad_xla`` and ``dgrad_pallas`` (interpret) at strides
  1, 2 and 4, in 3xTF32 against ``dgrad_xla`` at conv2-5's kernel shapes.
- **flash** (``csrc/flash_attention.cu``, bf16 path): the blocked flash
  recurrence with 64-key tiles, the kernel's causal and window tile skips,
  masks only on edge tiles and p rounded per tile, against JAX
  ``flash_attention_pallas(..., interpret=True)`` and the port's
  ``flash_attention_ref``, in fp32 (1e-5) and bf16 (2e-2 and relative RMS
  1e-2, the card's limits), for GQA, windows, ragged Sk and q_offsets;
  again at the wgmma kernel's tiles (128 queries a block, 128 keys a tile,
  64 at hd 256, p as 2^(x log2 e)), with cases at its edges (Sk one key
  past a tile, a window that skips whole 128-key tiles, hd 128 and 256).
- **shared memory**: the flash kernel's block (both dtypes, every head
  dim) and the forward's, wgrad's and dgrad's (both widths) fit the
  232,448 bytes an sm_90 block may use; the TF32 split scratches of W
  (forward, dgrad) and dY (wgrad) have 16-byte rows.
- **paged decode** (``csrc/paged_attention.cu``): the live keys cut into
  64-slot key tiles and split over ``paged_splits`` blocks as the kernel
  cuts them, each block walking its share with one running state in tiles
  of 64 slots (the bf16 wgmma kernel) or 16 (the fp32 kernel), p rounded
  per tile against the running max of its split, the splits combined in
  split order as the cluster combines them; against JAX
  ``paged_attention_pallas(..., interpret=True)`` and the port's
  ``paged_attention_ref`` in fp32 (1e-5) and bf16 (2e-2 and relative RMS
  1e-2): linear and ring caches, splits whose keys are all masked (8
  splits at 256-slot pages), a stale retired row, pos 0 and on a key
  tile's last slot, shares ending mid-tile, full tables, G in {1, 4, 7,
  16}, pages of 8 and of 5 slots (the kernel's ``cp.async`` route).
- **lowering-conv forward** (``csrc/lowering_conv.cu``): the lowered matrix
  gathered column by column in flat K order (taps outer, channels inner),
  the product in stages of 32 columns summed apart, in fp32 and in
  emulated 3xTF32, against JAX ``lowering_conv_xla`` and
  ``lowering_conv_pallas(..., interpret=True)`` at CaffeNet's conv1-5
  kernel shapes (reduced batch and image) within 1e-5 relative RMS, while
  one TF32 product misses that limit; the gathered residual is bitwise the
  port's and the JAX ``lower``. Again in the wgmma kernel's step order
  (each 32-column stage summed apart in 8-column steps, big*small,
  small*big, big*big one after the other) and split over K as the wrapper
  splits the shapes (each slice's partial apart, then summed in slice
  order), at the same shapes and limits.
- **wgrad** (``csrc/wgrad.cu``): dW = lowered^T @ dY with the M rows cut
  into ``wgrad_slices``'s slices, each slice summed in 32-row stages (each
  stage summed apart and then added) and the partials added in slice
  order, in fp32 and in emulated 3xTF32, against JAX ``wgrad_xla`` and
  ``wgrad_pallas(..., interpret=True)`` at CaffeNet's conv1-5 kernel
  shapes (reduced batch and image) within 1e-5 relative RMS, one case a
  single 4900-row slice past ``WGRAD_MAX_SLICE_ROWS``; one TF32 product
  misses that limit. Again in the wgmma kernel's step order (each 32-row
  stage summed apart in 8-row steps), at the same cases and limits.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.lowering_conv import bwd as jbwd
from repro.kernels.lowering_conv import ops as jlc
from repro.kernels.lowering_conv.lowering_conv import lowering_conv_pallas
from repro.kernels.lowering_conv.ref import lower as j_lower
from repro.kernels.paged_attention.paged_attention import \
    paged_attention_pallas
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.lowering_conv import bwd
from repro_torch.kernels.lowering_conv import lowering_conv as lc
from repro_torch.kernels.lowering_conv.ref import lower
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     valid_mask)

STAGE = 32          # output channels of one tap per dgrad stage
STEP = 8            # channels of one TF32 wgmma step (k8)
KEY_TILE = 64       # keys per flash tile (the mma.sync kernel's)
QUERY_TILE = 64     # queries per flash block (the mma.sync kernel's)
SMEM_LIMIT = 232448  # shared memory an sm_90 block may use


def _rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# dgrad: the implicit GEMM in the kernel's tap order
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 (10 mantissa bits), ties away from zero:
    cvt.rna.tf32.f32, by adding half of the 13 dropped bits and masking."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What the mma reads of an fp32 pattern: its top 10 mantissa bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product(a, b, mode):
    if mode == "fp32":
        return a @ b
    ab, bb = tf32(a), tf32(b)
    if mode == "1xtf32":
        return ab @ bb
    asm, bsm = tf32_truncated(a - ab), tf32_truncated(b - bb)
    return ab @ bsm + asm @ bb + ab @ bb


def implicit_dgrad(dy, w, x_shape, stride, mode="fp32"):
    """dX[b,h,w,c] = sum_{i,j,n} dY[b,(h-i)/s,(w-j)/s,n] * W[i,j,c,n], as
    the kernel takes it: an (B*H*W, Cin) GEMM of depth kh*kw*Cout, tap by
    tap in (i, j) order, each stage of 32 output channels summed apart and
    added to the running sum. A is dY gathered onto the dX grid (zero off
    the output and off the stride's lattice); B is W[i, j] as it lies."""
    b, h, wd, cin = x_shape
    kh, kw, _, cout = w.shape
    ho, wo = dy.shape[1], dy.shape[2]
    dx = torch.zeros((b * h * wd, cin), dtype=torch.float32)
    for i in range(kh):
        for j in range(kw):
            a = torch.zeros((b, h, wd, cout), dtype=torch.float32)
            a[:, i:i + (ho - 1) * stride + 1:stride,
              j:j + (wo - 1) * stride + 1:stride] = dy
            a = a.reshape(-1, cout)
            wt = w[i, j].T                            # (Cout, Cin)
            for n0 in range(0, cout, STAGE):
                dx += _product(a[:, n0:n0 + STAGE], wt[n0:n0 + STAGE], mode)
    return dx.reshape(x_shape)


def _dgrad_inputs(x_shape, w_shape, stride, seed, w_scale=0.05):
    rng = np.random.default_rng(seed)
    kh = w_shape[0]
    ho = (x_shape[1] - kh) // stride + 1
    wo = (x_shape[2] - w_shape[1]) // stride + 1
    dy = rng.standard_normal((x_shape[0], ho, wo, w_shape[3]))
    w = rng.standard_normal(w_shape) * w_scale
    return dy.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("stride,x_shape,w_shape", [
    (1, (2, 11, 11, 70), (3, 3, 70, 50)),       # Cin, Cout fill no tile
    (2, (2, 13, 13, 37), (5, 5, 37, 45)),       # taps off the lattice
    (4, (2, 23, 23, 3), (11, 11, 3, 35))])      # conv1-like, 121 taps
def test_implicit_dgrad_in_tap_order_matches_jax(stride, x_shape, w_shape):
    dy, w = _dgrad_inputs(x_shape, w_shape, stride, seed=stride)
    got = implicit_dgrad(torch.from_numpy(dy), torch.from_numpy(w), x_shape,
                         stride)
    want_xla = np.asarray(jbwd.dgrad_xla(jnp.asarray(dy), jnp.asarray(w),
                                         x_shape, stride))
    want_pallas = np.asarray(jbwd.dgrad_pallas(
        jnp.asarray(dy), jnp.asarray(w), x_shape, stride=stride, bp=1,
        interpret=True))
    assert _rel_max(got, want_xla) <= 1e-5
    assert _rel_max(got, want_pallas) <= 1e-5
    # the port's CPU path (the kernel's plain version) agrees as well
    plain = bwd.dgrad_cuda(torch.from_numpy(dy), torch.from_numpy(w),
                           x_shape, stride=stride)
    assert _rel_max(got, plain) <= 1e-5


@pytest.mark.parametrize("layer,x_shape,w_shape", [
    ("conv2", (2, 9, 9, 96), (5, 5, 96, 256)),
    ("conv3", (2, 7, 7, 256), (3, 3, 256, 384)),
    ("conv4", (2, 6, 6, 384), (3, 3, 384, 384)),
    ("conv5", (2, 5, 5, 384), (3, 3, 384, 256))])
def test_3xtf32_dgrad_holds_the_fp32_limit_and_one_tf32_does_not(
        layer, x_shape, w_shape):
    """CaffeNet's kernel shapes (K' = 6400, 3456, 3456, 2304) with the
    card's inputs (dY ~ N(0, 1), W ~ 0.05 N(0, 1)) at batch 2 and a
    reduced image."""
    dy, w = _dgrad_inputs(x_shape, w_shape, 1, seed=len(layer) + w_shape[3])
    want = np.asarray(jbwd.dgrad_xla(jnp.asarray(dy), jnp.asarray(w),
                                     x_shape, 1))
    dyt, wt = torch.from_numpy(dy), torch.from_numpy(w)
    three = implicit_dgrad(dyt, wt, x_shape, 1, mode="3xtf32")
    one = implicit_dgrad(dyt, wt, x_shape, 1, mode="1xtf32")
    assert _rel_rms(three, want) <= 1e-5
    assert _rel_max(three, want) <= 1e-4
    assert _rel_rms(one, want) > 1e-5          # why three products


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                           # TF32's spacing at 1
    x = torch.tensor([one, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0e-3], dtype=torch.float32)
    got = tf32(x)
    assert got[:5].tolist() == [one, one, one + ulp, one + ulp,
                                -(one + ulp)]
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert tf32_truncated(x)[:4].tolist() == [one, one, one, one]


@pytest.mark.parametrize("cin,want", [(96, 96), (256, 64), (384, 96),
                                      (70, 96), (16, 64)])
def test_dgrad_tile_width_pads_cin_least(cin, want):
    assert bwd.dgrad_block_n(cin) == want


def _step_product(a, b, mode):
    """One stage's sum as the wgmma kernel takes it: a fresh tile, the
    stage's 8-channel steps in order, each step's products added one after
    the other (3xTF32: big*small, small*big, big*big)."""
    part = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], STEP):
        ak, bk = a[:, k0:k0 + STEP], b[k0:k0 + STEP]
        if mode == "fp32":
            part = part + ak @ bk
            continue
        ab, bb = tf32(ak), tf32(bk)
        if mode == "1xtf32":
            part = part + ab @ bb
            continue
        asm, bsm = tf32_truncated(ak - ab), tf32_truncated(bk - bb)
        part = part + ab @ bsm
        part = part + asm @ bb
        part = part + ab @ bb
    return part


def wgmma_dgrad(dy, w, x_shape, stride, mode="fp32", block_m=128):
    """The wgmma kernel's dX: the rows (pixels) in blocks of ``block_m``,
    each block owning its rows; per block the taps in (i, j) order, per
    tap the stages of 32 output channels, each stage summed apart in
    8-channel steps (``_step_product``) and added to the running sum. W's
    big and small halves are split once, before the product (the kernel's
    prologue): the same values as a split per stage."""
    b, h, wd, cin = x_shape
    kh, kw, _, cout = w.shape
    ho, wo = dy.shape[1], dy.shape[2]
    taps = []
    for i in range(kh):
        for j in range(kw):
            a = torch.zeros((b, h, wd, cout), dtype=torch.float32)
            a[:, i:i + (ho - 1) * stride + 1:stride,
              j:j + (wo - 1) * stride + 1:stride] = dy
            taps.append((a.reshape(-1, cout), w[i, j].T))   # (Cout, Cin)
    m = b * h * wd
    dx = torch.zeros((m, cin), dtype=torch.float32)
    for r0 in range(0, m, block_m):
        acc = torch.zeros((min(block_m, m - r0), cin), dtype=torch.float32)
        for a, wt in taps:
            for n0 in range(0, cout, STAGE):
                acc = acc + _step_product(a[r0:r0 + block_m, n0:n0 + STAGE],
                                          wt[n0:n0 + STAGE], mode)
        dx[r0:r0 + block_m] = acc
    return dx.reshape(x_shape)


@pytest.mark.parametrize("stride,x_shape,w_shape", [
    (1, (2, 11, 11, 70), (3, 3, 70, 50)),       # Cin, Cout fill no tile
    (2, (2, 13, 13, 37), (5, 5, 37, 45)),       # taps off the lattice
    (4, (2, 23, 23, 3), (11, 11, 3, 35))])      # conv1-like, 121 taps
def test_wgmma_dgrad_in_step_order_matches_jax(stride, x_shape, w_shape):
    dy, w = _dgrad_inputs(x_shape, w_shape, stride, seed=stride)
    got = wgmma_dgrad(torch.from_numpy(dy), torch.from_numpy(w), x_shape,
                      stride)
    want_xla = np.asarray(jbwd.dgrad_xla(jnp.asarray(dy), jnp.asarray(w),
                                         x_shape, stride))
    want_pallas = np.asarray(jbwd.dgrad_pallas(
        jnp.asarray(dy), jnp.asarray(w), x_shape, stride=stride, bp=1,
        interpret=True))
    assert _rel_max(got, want_xla) <= 1e-5
    assert _rel_max(got, want_pallas) <= 1e-5


@pytest.mark.parametrize("block_m", [64, 128])
@pytest.mark.parametrize("layer,x_shape,w_shape", [
    ("conv2", (2, 9, 9, 96), (5, 5, 96, 256)),
    ("conv3", (2, 7, 7, 256), (3, 3, 256, 384)),
    ("conv4", (2, 6, 6, 384), (3, 3, 384, 384)),
    ("conv5", (2, 5, 5, 384), (3, 3, 384, 256))])
def test_wgmma_3xtf32_dgrad_in_step_order_holds_the_fp32_limit(
        layer, x_shape, w_shape, block_m):
    """The step order at the kernel's 128-pixel tiles and the 64-pixel
    tiles of the kernel before it, on CaffeNet's kernel shapes with the
    card's inputs (batch 2, reduced image), at the limits the tap-order
    oracle is held to."""
    dy, w = _dgrad_inputs(x_shape, w_shape, 1, seed=len(layer) + w_shape[3])
    want = np.asarray(jbwd.dgrad_xla(jnp.asarray(dy), jnp.asarray(w),
                                     x_shape, 1))
    three = wgmma_dgrad(torch.from_numpy(dy), torch.from_numpy(w), x_shape,
                        1, mode="3xtf32", block_m=block_m)
    assert _rel_rms(three, want) <= 1e-5
    assert _rel_max(three, want) <= 1e-4


@pytest.mark.parametrize("block_n", lc.BLOCK_N)
def test_dgrad_shared_memory_fits_a_block(block_n):
    """The wgmma ring (4 stages of 128 pixels and BN channels of W's big
    and small halves, 128-byte rows) fits an sm_90 block."""
    want = (1024 + lc.RING_STAGES * (lc.BLOCK_M + 2 * block_n) * 128
            + 16 * lc.RING_STAGES)
    assert lc.smem_bytes(pass_="dgrad", block_n=block_n) == want
    assert want <= SMEM_LIMIT


@pytest.mark.parametrize("block_n", lc.BLOCK_N)
@pytest.mark.parametrize("pass_", ["fwd", "wgrad"])
def test_fwd_and_wgrad_shared_memory_fit_a_block(pass_, block_n):
    """The forward's and wgrad's wgmma rings: 4 stages of a 128-row A tile
    (pixels x 32 columns of K; rows of dW x 32 reduction rows) and the B
    tile's big and small halves (BN rows of 32 fp32), 1024 bytes of
    alignment slack and two mbarriers a stage, within an sm_90 block."""
    want = (1024 + lc.RING_STAGES * (lc.BLOCK_M * 128 + 2 * block_n * 128)
            + 16 * lc.RING_STAGES)
    assert lc.smem_bytes(pass_=pass_, block_n=block_n) == want
    assert want <= SMEM_LIMIT


def test_dgrad_split_scratch_rows_are_16_byte_aligned():
    """W's big and small halves, Cout rounded up to 4 floats a row (TMA
    reads rows on 16-byte strides)."""
    assert bwd.dgrad_split_floats((5, 5, 96, 256)) == 2 * 25 * 96 * 256
    assert bwd.dgrad_split_floats((3, 3, 70, 50)) == 2 * 9 * 70 * 52
    assert bwd.dgrad_split_floats((3, 3, 8, 33)) == 2 * 9 * 8 * 36


def test_fwd_split_scratch_rows_are_16_byte_aligned():
    """The forward's W halves, transposed: (Cout, K4) each, K4 = K rounded
    up to 4 floats (TMA reads rows on 16-byte strides)."""
    assert lc.fwd_split_floats((11, 11, 3, 96)) == 2 * 96 * 364   # K = 363
    assert lc.fwd_split_floats((5, 5, 96, 256)) == 2 * 256 * 2400
    assert lc.fwd_split_floats((3, 3, 70, 50)) == 2 * 50 * 632    # K = 630
    assert lc.fwd_split_floats((3, 3, 1, 8)) == 2 * 8 * 12        # K = 9


def test_wgrad_split_scratch_rows_are_16_byte_aligned():
    """wgrad's dY halves, transposed: (Cout, M4) each, M4 = M rounded up
    to 4 floats."""
    assert bwd.wgrad_split_floats(64 * 55 * 55, 96) == 2 * 96 * 193600
    assert bwd.wgrad_split_floats(3 * 11 * 11, 64) == 2 * 64 * 364
    assert bwd.wgrad_split_floats(25, 96) == 2 * 96 * 28


# ---------------------------------------------------------------------------
# flash: the blocked recurrence with the kernel's tiles and skips
# ---------------------------------------------------------------------------

def _key_tiles(pmin, pmax, sk, causal, window, key_tile=KEY_TILE):
    """[t_begin, t_end) of the kernel's key tiles for a block of stored
    query positions pmin..pmax: past the last row's causal edge is skipped;
    wholly before the first row's window start is skipped unless some row's
    window holds no key at all."""
    kend = min(sk, pmax + 1) if causal else sk
    kbeg = 0
    if window is not None and window >= 1 and pmax - window + 1 <= sk - 1:
        kbeg = max(0, pmin - window + 1)
    return kbeg // key_tile, -(-kend // key_tile)


def blocked_flash(q, k, v, *, causal=True, window=None, q_offsets=None,
                  query_tile=QUERY_TILE, key_tile=KEY_TILE, exp2=False):
    """The bf16 kernel's recurrence in plain PyTorch: per (batch row,
    query block), the kept key tiles in order; scores in fp32 times the
    scale, masks only on edge tiles (-1e30, keys past Sk -inf), m from
    -1e30, l from the fp32 p, p rounded to q's type for PV. The tiles
    default to the mma.sync kernel's 64 x 64; ``exp2`` takes exp(x) as
    exp2(x * log2 e), as the wgmma kernel does. Returns (out, number of
    key tiles skipped)."""
    def exp(x):
        return torch.exp2(x * math.log2(math.e)) if exp2 else torch.exp(x)

    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    skipped = 0
    for bi in range(b):
        off = 0 if q_offsets is None else int(q_offsets[bi])
        kf = k[bi].float().repeat_interleave(g, dim=1)       # (Sk, H, hd)
        vf = v[bi].repeat_interleave(g, dim=1)
        for q0 in range(0, sq, query_tile):
            rows = min(query_tile, sq - q0)
            pmin, pmax = off + q0, off + q0 + rows - 1
            qf = q[bi, q0:q0 + rows].float()                 # (rows, H, hd)
            qpos = torch.arange(pmin, pmax + 1)[:, None]
            m = torch.full((h, rows), -1e30)
            l = torch.zeros((h, rows))
            acc = torch.zeros((h, rows, hd))
            t0, t1 = _key_tiles(pmin, pmax, sk, causal, window, key_tile)
            skipped += t0 + (-(-sk // key_tile) - t1)
            for t in range(t0, t1):
                k0 = t * key_tile
                kpos = torch.arange(k0, k0 + key_tile)[None, :]
                kt = torch.zeros((key_tile, h, hd))
                vt = torch.zeros((key_tile, h, hd), dtype=q.dtype)
                n = min(key_tile, sk - k0)
                kt[:n], vt[:n] = kf[k0:k0 + n], vf[k0:k0 + n]
                s = torch.einsum("qhd,khd->hqk", qf, kt) * scale
                edge = (k0 + key_tile > sk
                        or (causal and k0 + key_tile - 1 > pmin)
                        or (window is not None and k0 < pmax - window + 1))
                if edge:
                    ok = torch.ones((rows, key_tile), dtype=torch.bool)
                    if causal:
                        ok &= kpos <= qpos
                    if window is not None:
                        ok &= kpos > qpos - window
                    s = torch.where(ok, s, torch.tensor(-1e30))
                    s = torch.where(kpos >= sk, torch.tensor(-math.inf), s)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = exp(m - m_new)
                p = exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                pv = torch.einsum("hqk,khd->hqd", p.to(q.dtype).float(),
                                  vt.float())
                acc = acc * alpha[..., None] + pv
                m = m_new
            o = acc / torch.clamp(l, min=1e-30)[..., None]
            out[bi, q0:q0 + rows] = o.permute(1, 0, 2).to(q.dtype)
    return out, skipped


def _jax_flash(q, k, v, *, causal, window, q_offsets):
    """JAX ``flash_attention_pallas`` in interpret mode on the same values,
    through its (BH, S, hd) layout."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32

    def fold(t):
        x = jnp.asarray(t.float().numpy()).astype(jdt)
        return x.transpose(0, 2, 1, 3).reshape(-1, t.shape[1], hd)

    offs = None
    if q_offsets is not None:
        offs = jnp.repeat(jnp.asarray(q_offsets.numpy()), h)
    o = flash_attention_pallas(fold(q), fold(k), fold(v), causal=causal,
                               window=window, interpret=True,
                               kv_group=h // kh, q_offsets=offs)
    o = np.asarray(o.astype(jnp.float32)).reshape(b, h, sq, hd)
    return torch.from_numpy(o.transpose(0, 2, 1, 3).copy())


FLASH_CASES = {
    # name: (B, H, K, hd, Sq, Sk, causal, window, offsets range)
    "gqa causal ragged Sk": (2, 4, 2, 32, 150, 150, True, None, None),
    "window skips leading tiles": (2, 4, 2, 32, 200, 200, True, 40, None),
    "q_offsets chunk": (2, 4, 1, 32, 40, 200, True, None, (0, 160)),
    "decode Sq=1 window": (3, 4, 2, 32, 1, 190, True, 64, (100, 189)),
    "window past every key": (1, 2, 1, 32, 8, 64, True, 16, (100, 100)),
}


def _flash_inputs(case, dtype, seed):
    b, h, kh, hd, sq, sk, _, _, offs = case
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    q, k, v = mk(b, sq, h, hd), mk(b, sk, kh, hd), mk(b, sk, kh, hd)
    q_offsets = None
    if offs is not None:
        q_offsets = torch.from_numpy(rng.integers(
            offs[0], offs[1] + 1, size=b).astype(np.int32))
    return q, k, v, q_offsets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_blocked_flash_matches_jax_pallas_and_the_plain_version(name, dtype):
    case = FLASH_CASES[name]
    causal, window = case[6], case[7]
    q, k, v, offs = _flash_inputs(case, dtype, seed=len(name))
    got, skipped = blocked_flash(q, k, v, causal=causal, window=window,
                                 q_offsets=offs)
    if name == "window skips leading tiles":
        assert skipped > 0
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for want in (_jax_flash(q, k, v, causal=causal, window=window,
                            q_offsets=offs),
                 flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_offsets=offs).float()):
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
        if dtype == torch.bfloat16:
            assert _rel_rms(got.float(), want) <= 1e-2


WGMMA_FLASH_CASES = {
    **FLASH_CASES,
    "Sk one key past a 128-key tile": (2, 4, 2, 32, 129, 129, False, None,
                                       None),
    "window skips leading 128-key tiles": (1, 4, 2, 32, 400, 400, True, 40,
                                           None),
    "hd 128 chunk at offsets": (2, 4, 2, 128, 40, 250, True, None, (0, 210)),
    "hd 256 window, 64-key tiles": (1, 4, 1, 256, 150, 150, True, 64, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(WGMMA_FLASH_CASES))
def test_wgmma_blocked_flash_matches_jax_pallas_and_the_plain_version(
        name, dtype):
    """The recurrence at the wgmma kernel's tiles: 128 queries a block (two
    warpgroups of 64, one skip range for the block), 128 keys a tile (64 at
    hd 256), p by exp2."""
    case = WGMMA_FLASH_CASES[name]
    hd, causal, window = case[3], case[6], case[7]
    q, k, v, offs = _flash_inputs(case, dtype, seed=len(name))
    got, skipped = blocked_flash(
        q, k, v, causal=causal, window=window, q_offsets=offs,
        query_tile=fa.BF16_QUERY_TILE,
        key_tile=fa.bf16_key_tile(hd), exp2=True)
    if name == "window skips leading 128-key tiles":
        assert skipped > 0
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for want in (_jax_flash(q, k, v, causal=causal, window=window,
                            q_offsets=offs),
                 flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_offsets=offs).float()):
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
        if dtype == torch.bfloat16:
            assert _rel_rms(got.float(), want) <= 1e-2


@pytest.mark.parametrize("hd", list(fa.HEAD_DIMS))
def test_flash_shared_memory_fits_a_block(hd):
    """bf16: the Q tile (128 rows), the ring's stages of K and V tiles (3,
    2 at hd 256), the mbarriers and the stages' counts of warps done, with
    the alignment slack; fp32: the padded tiles."""
    for dtype in (torch.float32, torch.bfloat16):
        assert 0 < fa.smem_bytes(dtype, hd) <= SMEM_LIMIT
    bk, st = fa.bf16_key_tile(hd), fa.bf16_stages(hd)
    assert (bk, st) == ((64, 2) if hd == 256 else (128, 3))
    assert fa.smem_bytes(torch.bfloat16, hd) == (
        1024 + 2 * hd * (fa.BF16_QUERY_TILE + 2 * st * bk) + 8 * (1 + 2 * st)
        + 8 * st)
    # the swizzled tiles start on 1024-byte boundaries after the slack
    assert (2 * hd * fa.BF16_QUERY_TILE) % 1024 == 0
    assert (2 * hd * bk) % 1024 == 0


# ---------------------------------------------------------------------------
# paged decode: the split over key tiles and the combine in split order
# ---------------------------------------------------------------------------

def _merge(states):
    """(m, l, acc) states combined in order: weight exp(m - M), M the
    largest m."""
    big = torch.stack([m for m, _, _ in states]).amax(0)
    l_sum = torch.zeros_like(big)
    a_sum = torch.zeros_like(states[0][2])
    for m, l, a in states:
        wt = torch.exp(m - big)
        l_sum = l_sum + l * wt
        a_sum = a_sum + a * wt[:, None]
    return big, l_sum, a_sum


def split_paged(q, kp, vp, table, pos, *, window=None, tile=pa.KEY_TILE,
                splits=None):
    """The kernel's paged decode in plain PyTorch: a row's live slots
    [0, (jmax+1)*page) cut into ``pa.KEY_TILE``-slot key tiles, the tiles
    split over ``splits`` blocks (``ceil(n_tiles / splits)`` each), each
    block walking its share in tiles of ``tile`` slots (64 for the bf16
    kernel, 16 for the fp32 one) with one running state: scores in fp32
    times the scale, -1e30 where the slot is not valid and -inf past the
    share's end, p rounded to q's type for PV and l summed from the fp32
    p; the splits that hold tiles merged in split order. Returns (out,
    number of splits whose keys were all masked)."""
    b, _, h, hd = q.shape
    _, page, kh, _ = kp.shape
    n_pages = table.shape[1]
    g = h // kh
    W = n_pages * page
    T = pa.KEY_TILE
    if splits is None:
        splits = pa.paged_splits(b, kh, n_pages, page)
    scale = 1.0 / math.sqrt(hd)
    ok_all = valid_mask(pos, W, window)
    out = torch.empty_like(q)
    masked = 0
    for bi in range(b):
        p = int(pos[bi])
        jmax = n_pages - 1 if window is not None and p >= W else p // page
        live = (min(jmax, n_pages - 1) + 1) * page
        n_t = -(-live // T)
        per = max(1, -(-n_t // splits))
        slots = torch.arange(n_t * T)
        ids = table[bi].long()[torch.clamp(slots // page, max=n_pages - 1)]
        ok = ok_all[bi, torch.clamp(slots, max=W - 1)]
        for k in range(kh):
            keys = kp[ids, slots % page, k].float()
            vals = vp[ids, slots % page, k].float()
            qf = q[bi, 0, k * g:(k + 1) * g].float()
            parts = []
            for t0 in range(0, n_t, per):
                end = min(min(t0 + per, n_t) * T, live)
                m = torch.full((g,), -1e30)
                l = torch.zeros(g)
                acc = torch.zeros((g, hd))
                for s0 in range(t0 * T, end, tile):
                    sl = slots[s0:s0 + tile]
                    sc = (qf @ keys[sl].T) * scale
                    sc = torch.where(ok[sl], sc, torch.tensor(-1e30))
                    sc = torch.where(sl >= end, torch.tensor(-math.inf), sc)
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp(m - m_new)
                    pr = torch.exp(sc - m_new[:, None])
                    l = l * alpha + pr.sum(-1)
                    acc = (acc * alpha[:, None]
                           + pr.to(q.dtype).float() @ vals[sl])
                    m = m_new
                parts.append((m, l, acc))
                masked += int(bool((m <= -1e30).all()))
            _, l_sum, a_sum = _merge(parts)
            o = a_sum / torch.clamp(l_sum, min=1e-30)[:, None]
            out[bi, 0, k * g:(k + 1) * g] = o.to(q.dtype)
    return out, masked


PAGED_CASES = {
    # name: (B, K, G, page, n_pages, pos, window, stale rows, splits)
    "linear G1 pos 0 and a full table": (3, 2, 1, 16, 8, (0, 77, 127),
                                         None, (), None),
    "linear G4 stale retired row": (3, 2, 4, 16, 8, (5, 900, 64), None,
                                    (1,), None),
    "ring G7 wrapped rows": (3, 2, 7, 16, 8, (200, 15, 300), 128, (),
                             None),
    # 128-slot pages: a row at pos 5 has two live key tiles, the second
    # (a split of its own) all masked
    "ring with masked splits": (3, 2, 4, 128, 2, (5, 70, 400), 256, (),
                                None),
    # one split of 2 key tiles: one running state over both
    "full table G7, one split": (2, 2, 7, 16, 8, (127, 127), None, (), 1),
    "G16": (2, 1, 16, 16, 8, (5, 127), None, (), None),
    "8-slot pages": (3, 2, 4, 8, 16, (0, 77, 127), None, (), None),
    # 5-slot pages: no whole swizzle atom, the kernel's cp.async route
    "5-slot pages": (3, 2, 4, 5, 30, (4, 77, 149), None, (), None),
    "5-slot pages ring": (3, 2, 4, 5, 30, (4, 170, 333), 150, (), None),
    "shares ending mid-tile": (2, 2, 4, 16, 16, (100, 200), None, (),
                               None),
    # 8 splits of one key tile: a row at pos 3 leaves 3 of its 4 live
    # splits masked, a row at pos 300 3 of its 8
    "8 splits with masked splits": (2, 1, 4, 256, 2, (3, 300), None, (),
                                    None),
    "pos on a key tile's last slot": (3, 2, 4, 16, 16, (63, 127, 255),
                                      None, (), None),
}


def _paged_inputs(case, dtype, seed):
    b, kh, g, page, n_pages, pos, window, stale, _ = case
    rng = np.random.default_rng(seed)
    hd = 32
    n_pool = 1 + b * n_pages

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    q, kp, vp = (mk(b, 1, kh * g, hd), mk(n_pool, page, kh, hd),
                 mk(n_pool, page, kh, hd))
    table = torch.from_numpy((rng.permutation(n_pool - 1) + 1).astype(
        np.int32)).view(b, n_pages).clone()
    for bi, p in enumerate(pos):
        if window is None:                 # past the live page: scratch 0
            table[bi, min(p // page, n_pages - 1) + 1:] = 0
    for bi in stale:
        table[bi] = 0
    return q, kp, vp, table, torch.tensor(pos, dtype=torch.int32)


def _jax_paged(q, kp, vp, table, pos, window):
    b, _, h, hd = q.shape
    kh = kp.shape[2]
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32

    def cv(t):
        return jnp.asarray(t.float().numpy()).astype(jdt)

    o = paged_attention_pallas(cv(q.reshape(b, kh, h // kh, hd)), cv(kp),
                               cv(vp), jnp.asarray(table.numpy()),
                               jnp.asarray(pos.numpy()), window=window,
                               interpret=True)
    return torch.from_numpy(np.array(o.astype(jnp.float32))).reshape(
        b, 1, h, hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(PAGED_CASES))
def test_split_paged_decode_matches_jax_pallas_and_the_plain_version(
        name, dtype):
    case = PAGED_CASES[name]
    window, splits = case[6], case[8]
    q, kp, vp, table, pos = _paged_inputs(case, dtype, seed=len(name))
    tile = pa.KEY_TILE if dtype == torch.bfloat16 else pa.F32_TILE
    got, masked = split_paged(q, kp, vp, table, pos, window=window,
                              tile=tile, splits=splits)
    if "masked splits" in name:
        assert masked > 0                 # their weight exp(-1e30 - M) = 0
    assert torch.isfinite(got.float()).all()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for want in (_jax_paged(q, kp, vp, table, pos, window),
                 paged_attention_ref(q, kp, vp, table, pos,
                                     window=window).float()):
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
        if dtype == torch.bfloat16:
            assert _rel_rms(got.float(), want) <= 1e-2


@pytest.mark.parametrize("b,kh,n_pages,page,want", [
    (8, 4, 64, 16, 4),       # qwen2-7b serving: 8 x 4 x 4 = 128 blocks
    (3, 2, 8, 16, 2),        # one 64-slot tile a split
    (3, 2, 2, 64, 2),
    (64, 8, 4, 16, 1),       # B * K alone fills the card
    (1, 1, 64, 16, 8),       # at most MAX_SPLITS (a cluster), 2 tiles each
    (1, 1, 64, 64, 8),       # 8 tiles each
    (2, 1, 2, 256, 8),       # one tile each
    (1, 1, 4, 5, 1)])        # 20 slots: one ragged tile
def test_paged_splits_fill_the_card_from_the_shapes(b, kh, n_pages, page,
                                                    want):
    s = pa.paged_splits(b, kh, n_pages, page)
    assert s == want
    tiles = -(-n_pages * page // pa.KEY_TILE)
    per = -(-tiles // s)
    assert -(-tiles // per) == s          # no split is empty at a full table


@pytest.mark.parametrize("hd", pa.HEAD_DIMS)
def test_paged_shared_memory_fits_a_block(hd):
    for dtype in pa.DTYPES:
        assert 0 < pa.smem_bytes(dtype, hd) <= pa._SMEM_LIMIT
        assert pa.smem_bytes(dtype, hd) % 16 == 0
    # bf16: two blocks an SM, a ring of at least two key tiles (a split's
    # 128 slots at a full table at the serving shapes)
    assert pa.smem_bytes(torch.bfloat16, hd) <= pa.BLOCK_BUDGET
    assert 2 <= pa.bf16_stages(hd) <= pa.MAX_STAGES


# ---------------------------------------------------------------------------
# lowering-conv forward: the implicit GEMM in flat K order
# ---------------------------------------------------------------------------

def implicit_forward(x, w, stride, mode="fp32", stage=_product,
                     slice_stages=None):
    """y and the lowered residual as the kernel builds them: column
    k = (i, j, c) of row (b, ho, wo) gathered from x[b, ho*s + i, wo*s + j,
    c], in flat K order; the product in stages of 32 columns, each summed
    apart (by ``stage``) and added to the running sum. ``stage=
    _step_product`` is the wgmma kernel's order: each stage in 8-column
    steps from a fresh tile (W's halves come from the prologue's split:
    the same values as a split per stage; every row is its own sum, so the
    128-row tiles do not enter). ``slice_stages``: K split into runs of
    that many stages, each run's sum a partial of its own, the partials
    added in slice order (``lowering_conv.fwd_k_slices``)."""
    b, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    ho, wo = (h - kh) // stride + 1, (wd - kw) // stride + 1
    K = kh * kw * cin
    k = torch.arange(K)
    i, j, c = k // (kw * cin), (k % (kw * cin)) // cin, k % cin
    rows = (torch.arange(ho) * stride)[:, None, None] + i
    cols = (torch.arange(wo) * stride)[None, :, None] + j
    low = x[:, rows, cols, c]                          # (B, Ho, Wo, K)
    a, wm = low.reshape(-1, K), w.reshape(K, cout)
    y = torch.zeros((a.shape[0], cout), dtype=torch.float32)
    run = STAGE * (slice_stages or -(-K // STAGE))
    for z0 in range(0, K, run):
        part = torch.zeros_like(y)
        for k0 in range(z0, min(K, z0 + run), STAGE):
            part += stage(a[:, k0:k0 + STAGE], wm[k0:k0 + STAGE], mode)
        y += part
    return y.reshape(b, ho, wo, cout), low


FWD_CASES = [
    ("conv1", (2, 23, 23, 3), (11, 11, 3, 96), 4),
    ("conv2", (2, 9, 9, 96), (5, 5, 96, 256), 1),
    ("conv3", (2, 7, 7, 256), (3, 3, 256, 384), 1),
    ("conv4", (2, 6, 6, 384), (3, 3, 384, 384), 1),
    ("conv5", (2, 5, 5, 384), (3, 3, 384, 256), 1)]


@pytest.mark.parametrize("layer,x_shape,w_shape,stride", FWD_CASES)
def test_3xtf32_forward_in_flat_k_order_matches_jax(layer, x_shape, w_shape,
                                                    stride):
    """CaffeNet's kernel shapes (K = 363, 2400, 2304, 3456, 3456) with the
    card's inputs (x ~ N(0, 1), w ~ 0.05 N(0, 1)) at batch 2 and a reduced
    image."""
    rng = np.random.default_rng(w_shape[0] * 1000 + w_shape[3])
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) * 0.05).astype(np.float32)
    want_xla = np.asarray(jlc.lowering_conv_xla(jnp.asarray(x),
                                                jnp.asarray(w),
                                                stride=stride))
    want_pallas, low_pallas = lowering_conv_pallas(
        jnp.asarray(x), jnp.asarray(w), stride=stride, interpret=True,
        return_lowered=True)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    kh, kw = w_shape[:2]
    for mode in ("fp32", "3xtf32"):
        y, low = implicit_forward(xt, wt, stride, mode)
        for want in (want_xla, np.asarray(want_pallas)):
            assert _rel_rms(y, want) <= 1e-5, mode
            assert _rel_max(y, want) <= 1e-4, mode
        flat = low.reshape(-1, low.shape[-1])
        assert torch.equal(flat, lower(xt, kh, kw, stride))
        assert np.array_equal(flat.numpy(), np.asarray(
            j_lower(jnp.asarray(x), kh, kw, stride)))
        assert np.array_equal(low.numpy(), np.asarray(low_pallas))
    one, _ = implicit_forward(xt, wt, stride, "1xtf32")
    assert _rel_rms(one, want_xla) > 1e-5          # why three products


@pytest.mark.parametrize("layer,x_shape,w_shape,stride", FWD_CASES)
def test_wgmma_3xtf32_forward_in_step_order_matches_jax(layer, x_shape,
                                                        w_shape, stride):
    """The wgmma kernel's order on the same inputs as the flat-K oracle
    (CaffeNet's kernel shapes, batch 2, reduced image), split over K as the
    wrapper splits these shapes (2-8 slices), at its limits."""
    rng = np.random.default_rng(w_shape[0] * 1000 + w_shape[3])
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) * 0.05).astype(np.float32)
    want_xla = np.asarray(jlc.lowering_conv_xla(jnp.asarray(x),
                                                jnp.asarray(w),
                                                stride=stride))
    want_pallas = np.asarray(lowering_conv_pallas(
        jnp.asarray(x), jnp.asarray(w), stride=stride, interpret=True))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    kh, kw, cin, cout = w_shape
    ho = (x_shape[1] - kh) // stride + 1
    per, slices = lc.fwd_k_slices(x_shape[0] * ho * ho, kh * kw * cin, cout,
                                  lc.out_block_n(cout))
    assert slices > 1                      # the split is exercised
    for mode in ("fp32", "3xtf32"):
        y, low = implicit_forward(xt, wt, stride, mode, _step_product, per)
        for want in (want_xla, want_pallas):
            assert _rel_rms(y, want) <= 1e-5, mode
            assert _rel_max(y, want) <= 1e-4, mode
    assert torch.equal(low.reshape(-1, low.shape[-1]),
                       lower(xt, kh, kw, stride))
    one, _ = implicit_forward(xt, wt, stride, "1xtf32", _step_product, per)
    assert _rel_rms(one, want_xla) > 1e-5          # why three products


def test_forward_k_split_fills_the_card_at_caffenet_shapes():
    """At group batch 64, CaffeNet's conv4 and conv5 (100 and 39 tiles of
    128 x 96 on 132 SMs) are split over K; conv1-3 (1513, 795 and 164
    tiles) are not. Every split covers K's stages once, no slice empty."""
    from repro_torch.models import cnn as C
    got = []
    for xs, ws, s in C.conv_layer_shapes(C.CAFFENET, 64):
        kh, kw, cin, cout = ws
        ho = (xs[1] - kh) // s + 1
        k = kh * kw * cin
        per, slices = lc.fwd_k_slices(xs[0] * ho * ho, k, cout,
                                      lc.out_block_n(cout))
        n_k = -(-k // STAGE)
        assert (slices - 1) * per < n_k <= slices * per
        got.append(slices)
    assert got == [1, 1, 1, 2, 4]
    assert lc.fwd_k_slices(5, 9, 4, 64) == (1, 1)   # one stage: no split


# ---------------------------------------------------------------------------
# wgrad: split over the M rows, 32-row stages, partials in slice order
# ---------------------------------------------------------------------------

def split_wgrad(low, dy, mode="fp32", slice_rows=None, stage=_product):
    """dW = low^T @ dy as the kernel sums it: the M rows cut into slices of
    ``bwd.wgrad_slices``'s rows (or ``slice_rows``), each slice a sum of
    32-row stages, each stage summed apart (by ``stage``) and added to the
    slice's running sum, and the slices' partials added in slice order.
    ``stage=_step_product`` is the wgmma kernel's order: each stage in
    8-row steps from a fresh tile (dY's halves come from the prologue's
    split: the same values as a split per stage; every element of dW is
    its own sum, so the 128 x BN tiles do not enter)."""
    m, k = low.shape
    cout = dy.shape[1]
    rows = slice_rows or bwd.wgrad_slices(m, k, cout)[0]
    step = bwd.WGRAD_STAGE_ROWS
    dw = torch.zeros((k, cout), dtype=torch.float32)
    for z0 in range(0, m, rows):
        part = torch.zeros((k, cout), dtype=torch.float32)
        for q0 in range(z0, min(m, z0 + rows), step):
            q1 = min(m, z0 + rows, q0 + step)
            part += stage(low[q0:q1].T, dy[q0:q1], mode)
        dw += part
    return dw


WGRAD_CASES = {     # x_shape, w_shape, stride, slice_rows (None: the wrapper's)
    "conv1": ((2, 63, 63, 3), (11, 11, 3, 96), 4, None),
    "conv2": ((2, 27, 27, 96), (5, 5, 96, 256), 1, None),
    "conv3": ((2, 11, 11, 256), (3, 3, 256, 384), 1, None),
    "conv4": ((2, 9, 9, 384), (3, 3, 384, 384), 1, None),
    "conv5": ((2, 7, 7, 384), (3, 3, 384, 256), 1, None),
    # one slice of 4900 rows: past WGRAD_MAX_SLICE_ROWS, to test the cap
    "conv1_long_slice": ((4, 147, 147, 3), (11, 11, 3, 96), 4, 4928),
}


@pytest.mark.parametrize("case", list(WGRAD_CASES))
def test_3xtf32_split_wgrad_matches_jax(case):
    """CaffeNet's kernel shapes (K = 363, 2400, 2304, 3456, 3456) with the
    card's inputs (lowered from x ~ N(0, 1), dY ~ N(0, 1)) at a reduced
    batch and image, cut into the wrapper's slices (2-13 of them here)."""
    x_shape, w_shape, stride, slice_rows = WGRAD_CASES[case]
    kh, kw, _, cout = w_shape
    rng = np.random.default_rng(sum(w_shape) + len(case))
    x = rng.standard_normal(x_shape).astype(np.float32)
    low = lower(torch.from_numpy(x), kh, kw, stride)        # (M, K)
    m, k = low.shape
    ho = (x_shape[1] - kh) // stride + 1
    dy = rng.standard_normal((x_shape[0], ho, ho, cout)).astype(np.float32)
    dyt = torch.from_numpy(dy).reshape(m, cout)
    rows, slices = bwd.wgrad_slices(m, k, cout)
    if slice_rows is None:
        assert slices > 1                  # the split is exercised
    else:
        assert slice_rows >= max(4096, m) > bwd.WGRAD_MAX_SLICE_ROWS
    jlow = jnp.asarray(low.numpy())
    want_xla = np.asarray(jbwd.wgrad_xla(jlow, jnp.asarray(dy), w_shape))
    want_pallas = np.asarray(jbwd.wgrad_pallas(
        jlow.reshape(x_shape[0], ho, ho, k), jnp.asarray(dy), w_shape,
        interpret=True))
    for mode in ("fp32", "3xtf32"):
        got = split_wgrad(low, dyt, mode, slice_rows).reshape(w_shape)
        for want in (want_xla, want_pallas):
            assert _rel_rms(got, want) <= 1e-5, mode
            assert _rel_max(got, want) <= 1e-4, mode
    # the port's CPU path (the kernel's plain version) agrees as well
    plain = bwd.wgrad_cuda(low, dyt, w_shape)
    assert _rel_rms(plain, want_xla) <= 1e-5
    one = split_wgrad(low, dyt, "1xtf32", slice_rows).reshape(w_shape)
    assert _rel_rms(one, want_xla) > 1e-5          # why three products


@pytest.mark.parametrize("case", list(WGRAD_CASES))
def test_wgmma_3xtf32_wgrad_in_step_order_matches_jax(case):
    """The wgmma kernel's order on the same inputs as the 32-row-stage
    oracle (CaffeNet's kernel shapes at a reduced batch and image, the
    wrapper's slices; one 4900-row slice past the cap), at its limits."""
    x_shape, w_shape, stride, slice_rows = WGRAD_CASES[case]
    kh, kw, _, cout = w_shape
    rng = np.random.default_rng(sum(w_shape) + len(case))
    x = rng.standard_normal(x_shape).astype(np.float32)
    low = lower(torch.from_numpy(x), kh, kw, stride)        # (M, K)
    m, k = low.shape
    ho = (x_shape[1] - kh) // stride + 1
    dy = rng.standard_normal((x_shape[0], ho, ho, cout)).astype(np.float32)
    dyt = torch.from_numpy(dy).reshape(m, cout)
    jlow = jnp.asarray(low.numpy())
    want_xla = np.asarray(jbwd.wgrad_xla(jlow, jnp.asarray(dy), w_shape))
    want_pallas = np.asarray(jbwd.wgrad_pallas(
        jlow.reshape(x_shape[0], ho, ho, k), jnp.asarray(dy), w_shape,
        interpret=True))
    for mode in ("fp32", "3xtf32"):
        got = split_wgrad(low, dyt, mode, slice_rows,
                          _step_product).reshape(w_shape)
        for want in (want_xla, want_pallas):
            assert _rel_rms(got, want) <= 1e-5, mode
            assert _rel_max(got, want) <= 1e-4, mode
    one = split_wgrad(low, dyt, "1xtf32", slice_rows,
                      _step_product).reshape(w_shape)
    assert _rel_rms(one, want_xla) > 1e-5          # why three products
