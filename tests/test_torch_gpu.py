"""The port on the card: CUDA kernels against their plain versions, and the
kernel arms of the server against its plain arm.

Every test here needs a CUDA card and carries the ``gpu`` marker; without
a card each one skips (a skip is not a pass: ``chip_smoke.py`` is the
card's check). This file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: bf16 ``atol = rtol = 2e-2`` and fp32 ``1e-5`` against the plain
versions (summation order, and in bf16 where the plain version rounds);
served tokens equal between ``attn_impl="cuda"`` and ``"torch"`` in fp32.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.serving import (ContinuousServer, poisson_trace,
                                 sample_requests)

pytestmark = pytest.mark.gpu

DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; checked on the card by chip_smoke.py")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is compared
    return torch.device("cuda")


def _paged(card, dtype, *, B=3, K=2, G=4, hd=128, page=16, n_pages=4,
           pos=(5, 0, 63)):
    g = torch.Generator(device=card).manual_seed(0)
    P = 1 + B * n_pages
    q = torch.randn(B, 1, K * G, hd, generator=g, device=card).to(dtype)
    kp = torch.randn(P, page, K, hd, generator=g, device=card).to(dtype)
    vp = torch.randn(P, page, K, hd, generator=g, device=card).to(dtype)
    table = torch.arange(1, P, device=card, dtype=torch.int32).view(
        B, n_pages)
    return q, kp, vp, table, torch.tensor(pos, dtype=torch.int32,
                                          device=card)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("window", [None, 64])
def test_paged_kernel_matches_plain(card, dtype, tol, window):
    args = _paged(card, dtype, pos=(5, 0, 63) if window is None
                  else (5, 64, 200))                 # 64, 200: wrapped ring
    before = pa_ops.paged_attention.launches
    got = pa_ops.paged_attention(*args, window=window)
    assert pa_ops.paged_attention.launches == before + 1
    want = paged_attention_ref(*args, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_paged_kernel_rejects_bad_operands(card):
    q, kp, vp, table, pos = _paged(card, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        pa_ops.paged_attention(q, kp, vp, table.long(), pos)
    with pytest.raises(TypeError, match="dtype"):
        pa_ops.paged_attention(q.double(), kp.double(), vp.double(), table,
                               pos)
    with pytest.raises(ValueError, match="contiguous"):
        pa_ops.paged_attention(q, kp.transpose(0, 1).contiguous()
                               .transpose(0, 1), vp, table, pos)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_kernel_matches_plain(card, dtype, tol):
    g = torch.Generator(device=card).manual_seed(1)
    q = torch.randn(2, 100, 4, 128, generator=g, device=card).to(dtype)
    k = torch.randn(2, 100, 2, 128, generator=g, device=card).to(dtype)
    v = torch.randn(2, 100, 2, 128, generator=g, device=card).to(dtype)
    offs = torch.tensor([0, 7], dtype=torch.int32, device=card)
    for kw in ({"causal": True}, {"causal": True, "window": 33},
               {"causal": False}, {"causal": True, "q_offsets": offs}):
        got = fa_ops.flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def _cfg(window=None):
    return ArchConfig(name=f"t-gpu-w{window}", arch_type="dense",
                      num_layers=2, d_model=256, num_heads=4,
                      num_kv_heads=2, head_dim=64, d_ff=128, vocab_size=128,
                      sliding_window=window, compute_dtype="float32",
                      remat=False)


@pytest.mark.parametrize("prefill_mode,window", [("scan", None),
                                                 ("parallel", None),
                                                 ("scan", 32)])
def test_server_kernel_arm_serves_the_plain_arms_tokens(card, prefill_mode,
                                                        window):
    cfg = _cfg(window)
    reqs = sample_requests(poisson_trace(50.0, 6, seed=3), cfg,
                           prompt_range=(8, 40), gen_range=(4, 12), seed=3)
    toks = {}
    for impl in ("torch", "cuda"):
        srv = ContinuousServer(cfg, slots=4, page_size=16, max_seq=64,
                               window=window, attn_impl=impl,
                               prefill_mode=prefill_mode, device=card)
        toks[impl] = srv.run(reqs).tokens
    for rid in toks["torch"]:
        assert np.array_equal(toks["torch"][rid], toks["cuda"][rid]), rid


def test_cuda_gather_ring_fallback_warns_and_notes(card):
    from repro_torch.obs.metrics import MetricRegistry
    with pytest.warns(UserWarning, match="cuda_gather"):
        srv = ContinuousServer(_cfg(window=32), slots=2, page_size=16,
                               max_seq=64, attn_impl="cuda_gather",
                               device=card)
    assert any("falls back" in n for n in srv.registry.notes)
    fresh = MetricRegistry()
    srv.reset(registry=fresh)
    assert any("falls back" in n for n in fresh.notes)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        srv2 = ContinuousServer(_cfg(), slots=2, page_size=16, max_seq=64,
                                attn_impl="cuda_gather", device=card)
    assert srv2.registry.notes == []
