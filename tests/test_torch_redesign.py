"""The arithmetic of the two tensor-core kernels, on the CPU.

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
  TF32 product misses that limit.
- **flash** (``csrc/flash_attention.cu``, bf16 path): the blocked flash
  recurrence with 64-key tiles, the kernel's causal and window tile skips,
  masks only on edge tiles and p rounded per tile, against JAX
  ``flash_attention_pallas(..., interpret=True)`` and the port's
  ``flash_attention_ref``, in fp32 (1e-5) and bf16 (2e-2 and relative RMS
  1e-2, the card's limits), for GQA, windows, ragged Sk and q_offsets.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.lowering_conv import bwd as jbwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.lowering_conv import bwd

STAGE = 32          # output channels of one tap per dgrad stage
KEY_TILE = 64       # keys per flash tile
QUERY_TILE = 64     # queries per flash block


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


# ---------------------------------------------------------------------------
# flash: the blocked recurrence with the kernel's tiles and skips
# ---------------------------------------------------------------------------

def _key_tiles(pmin, pmax, sk, causal, window):
    """[t_begin, t_end) of the kernel's 64-key tiles for a block of stored
    query positions pmin..pmax: past the last row's causal edge is skipped;
    wholly before the first row's window start is skipped unless some row's
    window holds no key at all."""
    kend = min(sk, pmax + 1) if causal else sk
    kbeg = 0
    if window is not None and window >= 1 and pmax - window + 1 <= sk - 1:
        kbeg = max(0, pmin - window + 1)
    return kbeg // KEY_TILE, -(-kend // KEY_TILE)


def blocked_flash(q, k, v, *, causal=True, window=None, q_offsets=None):
    """The bf16 kernel's recurrence in plain PyTorch: per (batch row,
    64-query block), the kept 64-key tiles in order; scores in fp32 times
    the scale, masks only on edge tiles (-1e30, keys past Sk -inf), m from
    -1e30, l from the fp32 p, p rounded to q's type for PV. Returns
    (out, number of key tiles skipped)."""
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
        for q0 in range(0, sq, QUERY_TILE):
            rows = min(QUERY_TILE, sq - q0)
            pmin, pmax = off + q0, off + q0 + rows - 1
            qf = q[bi, q0:q0 + rows].float()                 # (rows, H, hd)
            qpos = torch.arange(pmin, pmax + 1)[:, None]
            m = torch.full((h, rows), -1e30)
            l = torch.zeros((h, rows))
            acc = torch.zeros((h, rows, hd))
            t0, t1 = _key_tiles(pmin, pmax, sk, causal, window)
            skipped += t0 + (-(-sk // KEY_TILE) - t1)
            for t in range(t0, t1):
                k0 = t * KEY_TILE
                kpos = torch.arange(k0, k0 + KEY_TILE)[None, :]
                kt = torch.zeros((KEY_TILE, h, hd))
                vt = torch.zeros((KEY_TILE, h, hd), dtype=q.dtype)
                n = min(KEY_TILE, sk - k0)
                kt[:n], vt[:n] = kf[k0:k0 + n], vf[k0:k0 + n]
                s = torch.einsum("qhd,khd->hqk", qf, kt) * scale
                edge = (k0 + KEY_TILE > sk
                        or (causal and k0 + KEY_TILE - 1 > pmin)
                        or (window is not None and k0 < pmax - window + 1))
                if edge:
                    ok = torch.ones((rows, KEY_TILE), dtype=torch.bool)
                    if causal:
                        ok &= kpos <= qpos
                    if window is not None:
                        ok &= kpos > qpos - window
                    s = torch.where(ok, s, torch.tensor(-1e30))
                    s = torch.where(kpos >= sk, torch.tensor(-math.inf), s)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
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
