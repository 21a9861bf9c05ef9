"""The port on the card: CUDA kernels against their plain versions, and the
kernel arms of the server and of the training engine against their plain
arms.

Every test here needs a CUDA card and carries the ``gpu`` marker; without
a card each one skips (a skip is not a pass: ``chip_smoke.py`` is the
card's check). This file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: bf16 ``atol = rtol = 2e-2`` and fp32 ``1e-5`` against the plain
versions (summation order, and in bf16 where the plain version rounds);
served tokens equal between ``attn_impl="cuda"`` and ``"torch"`` in fp32;
the flash arm raises when asked for gradients. The decode step's CUDA
graph (``attn_impl="cuda"``, dense and MoE, fp32 and bf16): every replay's
logits and tokens bitwise the eager step's over the same operands and
pool, through admissions, page crossings, retirements and re-admissions;
one capture at warmup and a replay a decode step; the same tokens after
``reset`` and a second capture; a scan prefill's stacked tokens the
eager ones; ``paged_attention.launches`` up by the layers a replay; the
gather arms on the card eager, their spans ``graph=False``.
The fused update is bitwise its plain version (same fp32 order, no FMA
contraction), with a plan's unequal group weights too; the conv kernels sum over K or M in another order than
cuBLAS (all three in 3xTF32 on tensor cores): max abs error
<= 1e-4 * max|want| and relative RMS <= 1e-5; the lowered residual is
bitwise; a training round agrees with the plain arms within 1e-4. The bf16
flash kernel's edge cases and the split paged kernel's bf16 cases also hold
a relative RMS error <= 1e-2; the split kernels (paged decode, wgrad)
give the same bits on a second call. The optimizer path's shapes: the conv
kernels at CaffeNet's planned per-group batch (93, the largest share of
the ``2xgpu-g2.2xlarge,2xcpu-c4.4xlarge`` plan at batch 256) and at
``cnn_classify``'s 12x12x1 image; ``profile_device`` times finished work.
The MoE and hybrid families' attention shapes: the flash kernel at head
dim 256 with 10 query heads on one kv head (recurrentgemma-2b's local
attention, window 2048, keys past it) and both kernels at G = 1
(qwen2-moe-a2.7b); ``moe_forward`` and the MoE ``paged_decode_step`` on
the card within 1e-4 of the CPU (fp32). The vlm and encdec families'
shapes: the flash kernel non-causal over a ragged 1500-frame sequence at
head dim 64, G = 1 (the Whisper encoder) and causal with 64 query heads
on 8 kv heads of 128 (llama-3.2-vision); ``make_prefill_step``'s kernel
arm within 1e-4 of the plain arm for both families (fp32, smoke widths);
trace replay of smoke lenet through the conv kernels within 1e-4 of the
CPU's plain arms. The conv-tile autotuner: every candidate tile of the
three conv kernels at the fp32 limits above (partial tiles: Cout 96 at
BN 64, Cout 256 and Cin 256 at BN 96), ``smem_bytes`` equal to each
compiled kernel's export, an unbuilt width refused, ``DEFAULT_TILES``
bitwise the launch that leaves the tiles out, and the launcher's
autotune probe and ``--trace-out`` on caffenet-smoke. The wgmma + TMA
kernels at their edges: the flash kernel's key tiles one key past a TMA
box (hd 128 and 256), hd 32's 64-byte swizzle, a batch row whose keys end
mid-box while the next row's are NaN (never read), its shared memory equal
to ``ops.smem_bytes``; the paged kernel's edges (TMA boxes of 8 slots,
5-slot pages on its cp.async route, linear and ring, 64- and 256-slot
pages, G = 16, hd 32 and 64), one device kernel a call under
``torch.profiler`` (no combine kernel), its shared memory equal to
``ops.smem_bytes``; dgrad's 128-pixel tiles (one pixel past, whole
tiles), a one-channel stage with 4-byte copies and stride 3, at both
widths; the forward's and wgrad's tiles at both widths: a partial
128-row tile, Cout below one tile, ragged Cout (50, 33: the W and dY
boxes past Cout zero-filled), conv1's K = 363 at stride 4 (4-byte
gathers; wgrad's A by cp.async, TMA refusing its 1452-byte rows) and
stride 3, the residual bitwise and both kernels' same bits on a second
call; the forward at conv1 and wgrad at conv1's rows at the planned
group batch 93. The Mamba-2 decode kernel against its plain version at
granite-4.0-h-small's serving shapes, the smoke shapes and its other row
splits, half the slots inactive, 4 steps chained: live state within 1e-5,
live y within rtol 1e-4 in fp32 (bf16 y at the bf16 limit), inactive
state bitwise and y 0, the same bits on a second launch; a replayed
Granite step adds one ``ssm_decode`` launch a Mamba layer.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as T
from repro_torch.data import pipeline as P
from repro_torch.engine import Engine
from repro_torch.kernels.fused_update import ops as fu_ops
from repro_torch.kernels.fused_update.ref import fused_update_ref
from repro_torch.kernels.lowering_conv import bwd as lc_bwd
from repro_torch.kernels.lowering_conv.lowering_conv import lowering_conv_cuda
from repro_torch.kernels.lowering_conv.ref import lower, lowered_conv_ref
from repro_torch.models import cnn as C
from repro_torch.optim.closed_form import grouped_coeffs, head_coeffs
from repro_torch.optim.sgd import init_momentum
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
    torch.backends.cudnn.allow_tf32 = False
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


def _check_split(card, dtype, tol, *, B, K, G, hd, page, n_pages, pos,
                 window=None, stale=()):
    """Pools with each row's own pages (past a linear row's live page the
    table points at scratch page 0), one launch against the plain version
    (bf16 also within relative RMS 1e-2), and a second call's bits."""
    g = torch.Generator(device=card).manual_seed(page + sum(pos))
    P = 1 + B * n_pages
    q = torch.randn(B, 1, K * G, hd, generator=g, device=card).to(dtype)
    kp = torch.randn(P, page, K, hd, generator=g, device=card).to(dtype)
    vp = torch.randn(P, page, K, hd, generator=g, device=card).to(dtype)
    table = (torch.randperm(P - 1, generator=g, device=card) + 1).view(
        B, n_pages).to(torch.int32)
    for b, p in enumerate(pos):
        if window is None:
            table[b, min(p // page, n_pages - 1) + 1:] = 0
    for b in stale:
        table[b] = 0
    args = (q, kp, vp, table.contiguous(),
            torch.tensor(pos, dtype=torch.int32, device=card))
    before = pa_ops.paged_attention.launches
    got = pa_ops.paged_attention(*args, window=window)
    assert pa_ops.paged_attention.launches == before + 1
    want = paged_attention_ref(*args, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert ((got.float() - want.float()).norm()
                / want.float().norm()).item() <= 1e-2
    assert torch.equal(pa_ops.paged_attention(*args, window=window), got)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", [
    # (page, n_pages, pos, window, stale rows), B = 4, K = 2, G = 7: each
    # row's keys split over several blocks
    (16, 16, (37, 255, 100, 900), None, (3,)),
    (64, 4, (5, 70, 255, 400), 256, ()),
    (16, 16, (255, 254, 253, 252), None, ()),
    (16, 16, (0, 1, 16, 300), 256, ())],
    ids=["splits-full-stale", "ring-masked-splits", "full-table",
         "ring-pos0-edges"])
def test_paged_split_kernel_matches_plain(card, dtype, tol, case):
    page, n_pages, pos, window, stale = case
    assert pa_ops.paged_splits(4, 2, n_pages, page) > 1
    _check_split(card, dtype, tol, B=4, K=2, G=7, hd=128, page=page,
                 n_pages=n_pages, pos=pos, window=window, stale=stale)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", [
    # (B, K, G, hd, page, n_pages, pos, window): the Hopper kernel's
    # edges, each row split over several blocks of one cluster
    (4, 2, 7, 128, 8, 32, (0, 7, 255, 100), None),      # TMA boxes of 8
    (4, 2, 7, 128, 5, 52, (4, 5, 259, 130), None),      # cp.async, no TMA
    (4, 2, 7, 128, 5, 52, (4, 259, 300, 777), 260),     # the same, a ring
    (4, 2, 7, 128, 64, 8, (63, 511, 200, 64), None),    # one page a tile
    (4, 2, 7, 128, 256, 4, (5, 1000, 300, 70), None),   # masked splits
    (4, 2, 16, 128, 16, 16, (0, 255, 100, 191), None),  # G = 16
    (4, 2, 7, 32, 16, 64, (1023, 1020, 1017, 1014), None),  # hd 32, full
    (4, 2, 7, 64, 16, 64, (1030, 1500, 2047, 1024), 1024)],  # hd 64, ring
    ids=["page8", "page5-cp-async", "page5-ring", "page64",
         "page256-masked-splits", "G16", "hd32-full-table", "hd64-ring"])
def test_paged_hopper_kernel_edges(card, dtype, tol, case):
    B, K, G, hd, page, n_pages, pos, window = case
    assert pa_ops.paged_splits(B, K, n_pages, page) > 1
    _check_split(card, dtype, tol, B=B, K=K, G=G, hd=hd, page=page,
                 n_pages=n_pages, pos=pos, window=window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_call_is_one_kernel(card, dtype):
    """One device kernel a call (the splits combine inside the cluster):
    no combine kernel, no scratch."""
    from torch.profiler import ProfilerActivity, profile
    args = _paged(card, dtype, B=8, K=4, G=7, n_pages=64,
                  pos=(1023, 100, 5, 700, 64, 900, 300, 17))
    pa_ops.paged_attention(*args)                          # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pa_ops.paged_attention(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert "paged_decode" in kernels[0].name
    assert "combine" not in kernels[0].name


def test_paged_shared_memory_model_is_the_kernels(card):
    for hd in pa_ops.HEAD_DIMS:
        for dtype in pa_ops.DTYPES:
            assert pa_ops.kernel_smem_bytes(dtype, hd) == \
                pa_ops.smem_bytes(dtype, hd)
    assert pa_ops.kernel_smem_bytes(torch.bfloat16, 48) == -1


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


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("case", [
    # (Sq, Sk, kwargs): Sk not a multiple of the 64-key tile; a window that
    # skips leading tiles; Sq = 1 and a short chunk at per-row offsets
    (150, 150, {}),
    (300, 300, {"window": 70}),
    (1, 333, {"q_offsets": (100, 332), "window": 64}),
    (40, 250, {"q_offsets": (0, 210)})],
    ids=["ragged-sk", "window-skips", "decode-offsets", "chunk-offsets"])
def test_flash_bf16_tensor_core_kernel_edges(card, hd, case):
    sq, sk, kw = case
    g = torch.Generator(device=card).manual_seed(hd + sq)
    b, h, kh = 3, 8, 2
    if "q_offsets" in kw:
        lo, hi = kw["q_offsets"]
        kw = dict(kw, q_offsets=torch.randint(lo, hi + 1, (b,), generator=g,
                                              device=card, dtype=torch.int32))
    q = torch.randn(b, sq, h, hd, generator=g, device=card).bfloat16()
    k = torch.randn(b, sk, kh, hd, generator=g, device=card).bfloat16()
    v = torch.randn(b, sk, kh, hd, generator=g, device=card).bfloat16()
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, causal=True, **kw).float()
    assert fa_ops.flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=True, **kw).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.parametrize("case", [
    # (hd, Sq, Sk, kwargs): Sk one key past a TMA box of keys (128 keys,
    # 64 at hd 256), causal, windowed and not; hd 32's 64-byte swizzle with
    # its keys ending mid-box
    (128, 129, 129, {}),
    (256, 65, 65, {"window": 40}),
    (64, 129, 129, {"causal": False}),
    (32, 200, 200, {"causal": False}),
    (32, 150, 150, {"window": 70})],
    ids=["sk-box-plus-one-hd128", "sk-box-plus-one-hd256-window",
         "sk-box-plus-one-hd64-noncausal", "hd32-swizzle64-noncausal",
         "hd32-swizzle64-window"])
def test_flash_bf16_wgmma_box_edges(card, case):
    hd, sq, sk, kw = case
    kw = {"causal": True, **kw}
    g = torch.Generator(device=card).manual_seed(hd + sk)
    b, h, kh = 2, 8, 2
    q = torch.randn(b, sq, h, hd, generator=g, device=card).bfloat16()
    k = torch.randn(b, sk, kh, hd, generator=g, device=card).bfloat16()
    v = torch.randn(b, sk, kh, hd, generator=g, device=card).bfloat16()
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, **kw).float()
    assert fa_ops.flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, **kw).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_bf16_reads_no_key_of_the_next_batch_row(card, hd):
    """Batch row 0's 150 keys end mid-box; row 1's keys and values are
    NaN. The 4-D tensor maps zero-fill row 0's last box past Sk, so its
    outputs stay finite and match the plain version (a box that ran on
    into row 1 would carry a NaN value into them, times p = 0)."""
    g = torch.Generator(device=card).manual_seed(hd)
    b, h, kh, s = 2, 4, 2, 150
    q = torch.randn(b, s, h, hd, generator=g, device=card).bfloat16()
    k = torch.randn(b, s, kh, hd, generator=g, device=card).bfloat16()
    v = torch.randn(b, s, kh, hd, generator=g, device=card).bfloat16()
    k[1] = float("nan")
    v[1] = float("nan")
    got = fa_ops.flash_attention(q, k, v, causal=False)[0].float()
    want = flash_attention_ref(q[:1], k[:1], v[:1], causal=False)[0].float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


def test_flash_shared_memory_model_is_the_kernels(card):
    for hd in fa_ops.HEAD_DIMS:
        for dtype in fa_ops.DTYPES:
            assert fa_ops.kernel_smem_bytes(dtype, hd) == \
                fa_ops.smem_bytes(dtype, hd)
    assert fa_ops.kernel_smem_bytes(torch.bfloat16, 48) == -1


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


# ---------------------------------------------------------------------------
# the decode step as one CUDA graph (attn_impl="cuda")
# ---------------------------------------------------------------------------

def _graph_cfg(family, dtype):
    cfg = _cfg() if family == "dense" else _moe_cfg()
    return dataclasses.replace(cfg, compute_dtype=dtype)


def _graph_reqs(cfg, n=7):
    """More requests than slots, all arriving at once: admissions, slots
    growing across 8-slot pages, retirements and re-admissions."""
    reqs = sample_requests(poisson_trace(1e6, n, seed=5), cfg,
                           prompt_range=(3, 14), gen_range=(6, 20), seed=5)
    return [dataclasses.replace(r, arrival=0.0) for r in reqs]


def _against_eager(srv):
    """Wrap a graphed server's ``_step`` (an instance attribute): after
    each replay, the eager step and its argmax over the same operands and
    the same pool (an active row rewrites the K and V the replay wrote)
    must give the replay's logits and tokens, bit for bit. Returns the
    occupancy of every step checked."""
    graphed, seen = srv._step, []

    def step(table, tokens, pos, active, gather_pages):
        got = graphed(table, tokens, pos, active, gather_pages)
        logits = srv._graph.logits.clone()
        want_logits, want = srv._decode(table, tokens, pos, active)
        assert torch.equal(logits, want_logits), len(seen)
        assert torch.equal(got, want), len(seen)
        seen.append(int(active.sum()))
        return got

    srv._step = step
    return seen


@pytest.mark.parametrize("family", ["dense", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_graph_replays_the_eager_step(card, family, dtype):
    from repro_torch.obs import spans
    from repro_torch.obs.metrics import MetricRegistry
    cfg = _graph_cfg(family, dtype)
    reqs = _graph_reqs(cfg)
    reg = MetricRegistry()
    srv = ContinuousServer(cfg, slots=3, page_size=8, max_seq=64,
                           attn_impl="cuda", prefill_mode="parallel",
                           registry=reg, device=card)
    srv.warmup(sorted({len(r.prompt) for r in reqs}))
    assert reg.counter("serving.decode_graph_captures").value == 1
    seen = _against_eager(srv)
    tracer = spans.Tracer()
    with spans.install(tracer):
        rep = srv.run(reqs)
    assert len(rep.rids) == len(reqs)
    dispatch = [r for r in tracer.records()
                if r.name == "serve.decode.dispatch"]
    assert len(dispatch) == len(seen)
    assert all(r.attrs["graph"] is True for r in dispatch)
    steps = len(reg.series("serving.decode_step_s").values)
    assert steps == len(seen) > 0 and min(seen) < 3 == max(seen)
    assert reg.counter("serving.decode_graph_replays").value == steps
    assert reg.counter("serving.decode_graph_captures").value == 1


def test_decode_graph_recaptures_after_reset(card):
    cfg = _graph_cfg("dense", "bfloat16")
    reqs = _graph_reqs(cfg)
    srv = ContinuousServer(cfg, slots=3, page_size=8, max_seq=64,
                           attn_impl="cuda", prefill_mode="parallel",
                           device=card)
    srv.warmup(sorted({len(r.prompt) for r in reqs}))
    first = srv.run(reqs).tokens
    graph = srv._graph
    srv.reset()
    assert srv._graph is None
    again = srv.run(reqs).tokens
    assert srv._graph is not graph
    assert srv.registry.counter("serving.decode_graph_captures").value == 2
    for rid in first:
        assert np.array_equal(first[rid], again[rid]), rid


def test_scan_prefill_through_the_graph_gives_the_eager_tokens(card):
    """The scan prefill stacks one ``_step`` result a prompt position: each
    must be its own tensor, not the graph's output buffer."""
    cfg = _graph_cfg("dense", "bfloat16")
    kw = dict(slots=3, page_size=8, max_seq=64, attn_impl="cuda",
              device=card)
    srv = ContinuousServer(cfg, **kw)
    twin = ContinuousServer(cfg, srv.params, **kw)
    S, Pb = 3, 16
    rng = np.random.default_rng(7)
    for s in range(S):
        srv.alloc.ensure(s, Pb)
        twin.alloc.ensure(s, Pb)
    table = torch.tensor(srv.alloc.tables, device=card)
    prompts = torch.tensor(rng.integers(cfg.vocab_size, size=(S, Pb)),
                           dtype=torch.int32, device=card)
    plens = torch.tensor([16, 5, 11], dtype=torch.int32, device=card)
    admit = torch.tensor([True, True, False], device=card)
    got = srv._scan_prefill(table, prompts, plens, admit, None)
    assert srv.registry.counter("serving.decode_graph_replays").value == Pb
    want = []
    for t in range(Pb):
        pos = torch.full((S,), t, dtype=torch.int32, device=card)
        want.append(twin._decode(table, prompts[:, t:t + 1], pos,
                                 admit & (t < plens))[1])
    assert torch.equal(got, torch.stack(want))
    assert len({tuple(row.tolist()) for row in got}) > 1


def test_decode_graph_replay_counts_its_paged_launches(card):
    cfg = _graph_cfg("moe", "bfloat16")
    srv = ContinuousServer(cfg, slots=3, page_size=8, max_seq=64,
                           attn_impl="cuda", device=card)
    srv.warmup()
    S = srv.spec.num_slots
    ops = (torch.tensor(srv.alloc.tables, device=card),
           torch.zeros((S, 1), dtype=torch.int32, device=card),
           torch.zeros((S,), dtype=torch.int32, device=card),
           torch.zeros((S,), dtype=torch.bool, device=card))
    assert srv._graph.launches == cfg.num_layers
    for n in (1, 2):
        before = pa_ops.paged_attention.launches
        for _ in range(n):
            srv._step(*ops, None)
        assert pa_ops.paged_attention.launches == before + n * cfg.num_layers


@pytest.mark.parametrize("attn_impl", ["torch", "cuda_gather"])
def test_gather_arms_on_the_card_run_the_eager_step(card, attn_impl):
    from repro_torch.obs import spans
    cfg = _graph_cfg("dense", "bfloat16")
    reqs = _graph_reqs(cfg, n=4)
    srv = ContinuousServer(cfg, slots=3, page_size=8, max_seq=64,
                           attn_impl=attn_impl, device=card)
    tracer = spans.Tracer()
    with spans.install(tracer):
        srv.warmup(sorted({len(r.prompt) for r in reqs}))
        srv.run(reqs)
    dispatch = [r for r in tracer.records()
                if r.name == "serve.decode.dispatch"]
    assert dispatch and all(r.attrs["graph"] is False for r in dispatch)
    assert srv._graph is None
    assert srv.registry.counter("serving.decode_graph_replays").value == 0
    assert srv.registry.counter("serving.decode_graph_captures").value == 0


def test_flash_arm_refuses_gradients_and_serves_under_no_grad(card):
    """The flash kernel is forward-only: ``lm_loss(..., attn_impl="cuda")``
    under ``autograd.grad`` raises, naming the ROADMAP item, where it would
    otherwise cut q, k and v out of the graph; under ``no_grad`` the arm
    gives the logits it gives without gradients, within 1e-4 of the plain
    arm (fp32)."""
    from repro_torch.core.async_sgd import value_and_grad
    from repro_torch.models import transformer as M
    cfg = _cfg()
    params = M.init_params(torch.Generator(device=card).manual_seed(0), cfg)
    toks = torch.randint(cfg.vocab_size, (2, 33), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with pytest.raises(NotImplementedError, match="forward-only.*ROADMAP"):
        value_and_grad(lambda p, b: M.lm_loss(p, b, cfg, attn_impl="cuda"),
                       params, batch)
    before = fa_ops.flash_attention.launches
    plain = M.forward(params, batch, cfg, attn_impl="cuda")[0]
    with torch.no_grad():
        logits = M.forward(params, batch, cfg, attn_impl="cuda")[0]
    assert fa_ops.flash_attention.launches == before + 2 * cfg.num_layers
    assert torch.equal(logits, plain)
    torch.testing.assert_close(
        logits, M.forward(params, batch, cfg, attn_impl="torch")[0],
        rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the CNN-training kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wdt,vdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("n", [1, 7, 4096, 100003])
def test_fused_update_kernel_is_bitwise_the_plain_version(card, wdt, vdt, n):
    g = torch.Generator(device=card).manual_seed(n)
    w = torch.randn(n, generator=g, device=card).to(wdt)
    v = torch.randn(n, generator=g, device=card).to(vdt)
    gs = torch.randn(4, n, generator=g, device=card)
    c = grouped_coeffs(4, lr=0.05, momentum=0.9, weight_decay=1e-4)
    before = fu_ops.fused_update_cuda.launches
    got = fu_ops.fused_update_cuda(w, v, gs, c)
    assert fu_ops.fused_update_cuda.launches == before + 1
    want = fused_update_ref(w, v, gs, c)
    assert got[0].dtype == wdt and got[1].dtype == vdt
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_update_kernel_rejects_bad_operands(card):
    w = torch.zeros(8, device=card)
    with pytest.raises(ValueError, match="groups"):
        fu_ops.fused_update_cuda(w, w, torch.zeros(65, 8, device=card),
                                 grouped_coeffs(65, lr=0.1))
    with pytest.raises(ValueError, match="contiguous"):
        fu_ops.fused_update_cuda(w, w, torch.zeros(8, 2, device=card).T,
                                 grouped_coeffs(2, lr=0.1))


def _fp32_close(got, want):
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-5, rel


PLANNED_GROUP_BATCH = 93          # max((93, 93, 35, 35)): the planned round
PLANNED_WEIGHTS = (93 / 256, 93 / 256, 35 / 256, 35 / 256)


def _cnn_classify_layers(batch):
    from repro_torch.core.workload import cnn_config
    return C.conv_layer_shapes(cnn_config(), batch)


@pytest.mark.parametrize("x_shape,w_shape,stride", [
    ((4, 23, 23, 3), (11, 11, 3, 16), 4),       # conv1-like, K = 363
    ((3, 13, 13, 24), (5, 5, 24, 70), 1),       # ragged Cout tile
    ((2, 9, 9, 40), (3, 3, 40, 64), 1),
    ((2, 12, 12, 8), (3, 3, 8, 16), 2),         # stride-2 dgrad
    # the optimizer path: CaffeNet at the planned per-group batch, and
    # cnn_classify's 12x12x1 image (K = 9) at g = 1 and g = 2
    *C.conv_layer_shapes(C.CAFFENET, PLANNED_GROUP_BATCH),
    *_cnn_classify_layers(16), *_cnn_classify_layers(8)])
def test_conv_kernels_match_plain(card, x_shape, w_shape, stride):
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(x_shape, generator=g, device=card)
    w = torch.randn(w_shape, generator=g, device=card) * 0.1
    kh, kw = w_shape[:2]
    y, low = lowering_conv_cuda(x, w, stride=stride, return_lowered=True)
    want_low = lower(x, kh, kw, stride)
    assert torch.equal(low.reshape(want_low.shape), want_low)
    _fp32_close(y, lowered_conv_ref(x, w, stride))
    assert torch.equal(lowering_conv_cuda(x, w, stride=stride), y)
    dy = torch.randn(y.shape, generator=g, device=card)
    dw = lc_bwd.wgrad_cuda(low, dy, w.shape)
    _fp32_close(dw, lc_bwd.wgrad_ref(want_low, dy, w.shape))
    assert torch.equal(lc_bwd.wgrad_cuda(low, dy, w.shape), dw)  # no atomics
    dx = lc_bwd.dgrad_cuda(dy, w, x.shape, stride=stride)
    _fp32_close(dx, lc_bwd.dgrad_ref(dy, w, x.shape, stride))


@pytest.mark.parametrize("block_n", [64, 96])
@pytest.mark.parametrize("x_shape,w_shape,stride", [
    ((1, 3, 43, 40), (3, 3, 40, 24), 1),    # M = 129; Cout < one stage
    ((3, 8, 16, 100), (2, 2, 100, 33), 1),  # M = 3 x 128; Cout 33: 4-byte copies
    ((2, 14, 14, 64), (4, 4, 64, 96), 3)],  # stride 3
    ids=["M-tile-plus-one", "whole-tiles-cout33", "stride3"])
def test_dgrad_wgmma_tile_edges(card, x_shape, w_shape, stride, block_n):
    """The wgmma kernel's edges: 128-pixel tiles (one pixel past, whole),
    a stage of one output channel, W boxes past Cin and Cout (zero-filled
    by TMA), at both widths; the same bits on a second call."""
    g = torch.Generator(device=card).manual_seed(sum(x_shape) + block_n)
    kh, kw = w_shape[:2]
    ho = (x_shape[1] - kh) // stride + 1
    wo = (x_shape[2] - kw) // stride + 1
    w = torch.randn(w_shape, generator=g, device=card) * 0.05
    dy = torch.randn((x_shape[0], ho, wo, w_shape[3]), generator=g,
                     device=card)
    tiles = dataclasses.replace(lc_bwd.default_tiles(w_shape),
                                dgrad_bn=block_n)
    before = lc_bwd.dgrad_cuda.launches
    dx = lc_bwd.dgrad_cuda(dy, w, x_shape, stride=stride, tiles=tiles)
    assert lc_bwd.dgrad_cuda.launches == before + 1
    _fp32_close(dx, lc_bwd.dgrad_ref(dy, w, x_shape, stride))
    assert torch.equal(lc_bwd.dgrad_cuda(dy, w, x_shape, stride=stride,
                                         tiles=tiles), dx)


@pytest.mark.parametrize("block_n", [64, 96])
@pytest.mark.parametrize("x_shape,w_shape,stride", [
    ((1, 3, 43, 40), (3, 3, 40, 24), 1),    # M = 41 < one tile; Cout < BN
    ((3, 13, 13, 24), (5, 5, 24, 50), 1),   # ragged Cout 50; K = 600
    ((3, 8, 16, 100), (2, 2, 100, 33), 1),  # Cout 33, K = 400
    ((4, 63, 63, 3), (11, 11, 3, 96), 4),   # conv1's K = 363 at stride 4
    ((2, 14, 14, 64), (4, 4, 64, 96), 3)],  # stride 3
    ids=["M41", "cout50", "cout33", "k363-s4", "stride3"])
def test_fwd_and_wgrad_wgmma_tile_edges(card, x_shape, w_shape, stride,
                                        block_n):
    """The wgmma forward's and wgrad's edges at both widths: partial
    128-row tiles, W and dY boxes past Cout and K zero-filled by TMA, the
    4-byte gathers of conv1's K = 363 (wgrad's A by cp.async there); the
    residual bitwise, one launch a call, the same bits on a second
    call."""
    g = torch.Generator(device=card).manual_seed(sum(x_shape) + block_n)
    kh, kw = w_shape[:2]
    x = torch.randn(x_shape, generator=g, device=card)
    w = torch.randn(w_shape, generator=g, device=card) * 0.05
    tiles = dataclasses.replace(lc_bwd.default_tiles(w_shape),
                                fwd_bn=block_n, wgrad_bn=block_n)
    before = lowering_conv_cuda.launches
    y, low = lowering_conv_cuda(x, w, stride=stride, return_lowered=True,
                                tiles=tiles)
    assert lowering_conv_cuda.launches == before + 1
    _fp32_close(y, lowered_conv_ref(x, w, stride))
    want_low = lower(x, kh, kw, stride)
    assert torch.equal(low.reshape(want_low.shape), want_low)
    y2, low2 = lowering_conv_cuda(x, w, stride=stride, return_lowered=True,
                                  tiles=tiles)
    assert torch.equal(y2, y) and torch.equal(low2, low)
    dy = torch.randn(y.shape, generator=g, device=card)
    before = lc_bwd.wgrad_cuda.launches
    dw = lc_bwd.wgrad_cuda(low, dy, w_shape, tiles=tiles)
    assert lc_bwd.wgrad_cuda.launches == before + 1
    _fp32_close(dw, lc_bwd.wgrad_ref(want_low, dy, w_shape))
    assert torch.equal(lc_bwd.wgrad_cuda(low, dy, w_shape, tiles=tiles), dw)


@pytest.mark.parametrize("x_shape,w_shape,stride", [
    ((8, 27, 27, 96), (5, 5, 96, 256), 1),      # CaffeNet conv2
    ((8, 13, 13, 256), (3, 3, 256, 384), 1),    # conv3
    ((8, 13, 13, 384), (3, 3, 384, 384), 1),    # conv4
    ((8, 13, 13, 384), (3, 3, 384, 256), 1),    # conv5
    ((8, 15, 15, 130), (3, 3, 130, 36), 1),     # ragged tile and stage
    ((8, 13, 13, 70), (3, 3, 70, 50), 1),       # Cout % 4 != 0
    ((8, 27, 27, 96), (5, 5, 96, 256), 2)])     # stride 2
def test_dgrad_3xtf32_kernel_holds_fp32_limits(card, x_shape, w_shape,
                                              stride):
    g = torch.Generator(device=card).manual_seed(w_shape[3])
    kh = w_shape[0]
    ho = (x_shape[1] - kh) // stride + 1
    w = torch.randn(w_shape, generator=g, device=card) * 0.05
    dy = torch.randn((x_shape[0], ho, ho, w_shape[3]), generator=g,
                     device=card)
    before = lc_bwd.dgrad_cuda.launches
    dx = lc_bwd.dgrad_cuda(dy, w, x_shape, stride=stride)
    assert lc_bwd.dgrad_cuda.launches == before + 1
    _fp32_close(dx, lc_bwd.dgrad_ref(dy, w, x_shape, stride))
    assert torch.equal(lc_bwd.dgrad_cuda(dy, w, x_shape, stride=stride), dx)


@pytest.mark.parametrize("x_shape,w_shape,stride", [
    *C.conv_layer_shapes(C.CAFFENET, 8),        # CaffeNet conv1-5, batch 8
    ((8, 15, 15, 40), (3, 3, 40, 70), 1),       # ragged stage and Cout tile
    ((8, 27, 27, 96), (5, 5, 96, 256), 2),      # stride 2
    ((8, 13, 13, 70), (3, 3, 70, 50), 1),       # ragged Cout 50, K = 630
    C.conv_layer_shapes(C.CAFFENET, 93)[0]],    # conv1 at the planned batch
    ids=["conv1", "conv2", "conv3", "conv4", "conv5", "ragged", "stride2",
         "cout50", "conv1-b93"])
def test_lowering_conv_3xtf32_kernel_holds_fp32_limits(card, x_shape,
                                                      w_shape, stride):
    g = torch.Generator(device=card).manual_seed(w_shape[3] + stride)
    x = torch.randn(x_shape, generator=g, device=card)
    w = torch.randn(w_shape, generator=g, device=card) * 0.05
    kh, kw = w_shape[:2]
    before = lowering_conv_cuda.launches
    y, low = lowering_conv_cuda(x, w, stride=stride, return_lowered=True)
    assert lowering_conv_cuda.launches == before + 1
    _fp32_close(y, lowered_conv_ref(x, w, stride))
    want_low = lower(x, kh, kw, stride)
    assert torch.equal(low.reshape(want_low.shape), want_low)
    y2, low2 = lowering_conv_cuda(x, w, stride=stride, return_lowered=True)
    assert torch.equal(y2, y) and torch.equal(low2, low)
    assert torch.equal(lowering_conv_cuda(x, w, stride=stride), y)


@pytest.mark.parametrize("m,kshape", [
    *[((8 * ((x[1] - w[0]) // s + 1) ** 2), w)
      for x, w, s in C.conv_layer_shapes(C.CAFFENET, 8)],   # conv1-5, batch 8
    (64 * 11 * 11, (3, 3, 70, 50)),        # Cout % 4 != 0: 4-byte copies
    (64 * 13 * 13, (3, 3, 130, 36)),       # ragged K and Cout tiles
    (3 * 11 * 11, (3, 3, 96, 64)),         # M no multiple of the 32-row stage
    (25, (3, 3, 96, 96)),                  # M < 32: one ragged stage
    (93 * 55 * 55, (11, 11, 3, 96))],      # conv1 at the planned batch 93
    ids=["conv1", "conv2", "conv3", "conv4", "conv5", "cout50", "cout36",
         "m363", "m25", "conv1-b93"])
def test_wgrad_3xtf32_kernel_holds_fp32_limits(card, m, kshape):
    g = torch.Generator(device=card).manual_seed(m + kshape[3])
    kh, kw, cin, cout = kshape
    low = torch.randn((m, kh * kw * cin), generator=g, device=card)
    dy = torch.randn((m, cout), generator=g, device=card)
    before = lc_bwd.wgrad_cuda.launches
    dw = lc_bwd.wgrad_cuda(low, dy, kshape)
    assert lc_bwd.wgrad_cuda.launches == before + 1
    _fp32_close(dw, lc_bwd.wgrad_ref(low, dy, kshape))
    assert torch.equal(lc_bwd.wgrad_cuda(low, dy, kshape), dw)  # no atomics


@pytest.mark.parametrize("g,sizes", [(2, None), (4, (6, 4, 3, 3))])
def test_training_kernel_arms_match_plain_arms(card, g, sizes):
    """caffenet-smoke, three rounds at g=2 with equal shares of a batch of
    8, and at g=4 with a plan's unequal shares (6, 4, 3, 3) of 16 and their
    weights: lowering_cuda + the fused-update kernel against lowering + the
    plain update, and every kernel of the path launched."""
    base = C.get_cnn_smoke_config("caffenet")
    params = C.init_params(torch.Generator(device=card).manual_seed(0), base)
    batch = sum(sizes) if sizes else 8
    weights = tuple(s / batch for s in sizes) if sizes else None
    out = {}
    for conv, upd in (("lowering", "torch"), ("lowering_cuda", "cuda")):
        cfg = dataclasses.replace(base, conv_impl=conv)
        eng = Engine(lambda p, b, cfg=cfg: C.loss_fn(p, b, cfg),
                     num_groups=g, lr=0.05, momentum=0.3, update_impl=upd,
                     group_weights=weights, micro_sizes=sizes,
                     head_filter=C.head_filter, device=card)
        data = P.SyntheticImages(P.DataConfig(
            batch_size=batch, image_size=cfg.image_size,
            channels=cfg.in_channels, num_classes=cfg.num_classes))
        n = lc_bwd.dgrad_cuda.launches
        out[conv] = eng.run(params, init_momentum(params),
                            data.batches(3), steps=3)
        if conv == "lowering_cuda":
            assert lc_bwd.dgrad_cuda.launches - n == 3 * g * 1
    np.testing.assert_allclose(out["lowering_cuda"][2], out["lowering"][2],
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(T.leaves(out["lowering_cuda"][0]),
                    T.leaves(out["lowering"][0])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the optimizer path: planned shares, cnn_classify, the black-box probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [7, 4096, 100003])
def test_fused_update_kernel_is_bitwise_plain_with_plan_weights(card, n):
    g = torch.Generator(device=card).manual_seed(n)
    w = torch.randn(n, generator=g, device=card)
    v = torch.randn(n, generator=g, device=card)
    gs = torch.randn(4, n, generator=g, device=card)
    kw = dict(lr=0.01, momentum=0.3, weight_decay=5e-4,
              group_weights=PLANNED_WEIGHTS)
    for c in (grouped_coeffs(4, **kw), head_coeffs(4, **kw)):
        assert len(set(c.a)) > 1              # non-uniform coefficients
        got = fu_ops.fused_update_cuda(w, v, gs, c)
        want = fused_update_ref(w, v, gs, c)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_profile_device_synchronizes(card):
    """A step that queues ~10 ms of device work and returns at once: the
    probe reads the clock after the work, not after the enqueue."""
    from repro_torch.cluster import profile_device
    cycles = 20_000_000
    torch.cuda._sleep(cycles)                 # warm the spin kernel
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    sleep_s = start.elapsed_time(end) / 1e3
    thr = profile_device(lambda: torch.cuda._sleep(cycles), (),
                         batch_size=1, warmup=1, iters=3, device=card)
    assert 1.0 / thr >= 0.8 * sleep_s, (1.0 / thr, sleep_s)


# ---------------------------------------------------------------------------
# the MoE and hybrid families' shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_kernel_hd256_gqa10_window(card, dtype, tol):
    """recurrentgemma-2b's local attention: 10 query heads on one kv head
    of 256, window 2048, keys past the window."""
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(2, 2300, 10, 256, generator=g, device=card).to(dtype)
    k = torch.randn(2, 2300, 1, 256, generator=g, device=card).to(dtype)
    v = torch.randn(2, 2300, 1, 256, generator=g, device=card).to(dtype)
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, causal=True, window=2048).float()
    assert fa_ops.flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=True, window=2048).float()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_kernel_group_of_one(card, dtype, tol):
    """qwen2-moe-a2.7b: 16 query heads on 16 kv heads (G = 1)."""
    g = torch.Generator(device=card).manual_seed(8)
    q = torch.randn(2, 300, 16, 128, generator=g, device=card).to(dtype)
    k = torch.randn(2, 300, 16, 128, generator=g, device=card).to(dtype)
    v = torch.randn(2, 300, 16, 128, generator=g, device=card).to(dtype)
    got = fa_ops.flash_attention(q, k, v, causal=True).float()
    want = flash_attention_ref(q, k, v, causal=True).float()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_paged_kernel_group_of_one(card, dtype, tol):
    """G = 1: one live row of the product's 64."""
    args = _paged(card, dtype, B=4, K=16, G=1, n_pages=16,
                  pos=(5, 0, 255, 130))
    got = pa_ops.paged_attention(*args)
    want = paged_attention_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(pa_ops.paged_attention(*args), got)


def _moe_cfg():
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"),
                               compute_dtype="float32", remat=False)


def test_moe_forward_on_the_card_matches_the_cpu(card):
    from repro_torch.models import moe as M
    cfg = _moe_cfg()
    p = M.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want_y, want_aux = M.moe_forward(p, x, cfg)
    got_y, got_aux = M.moe_forward(T.tree_map(lambda t: t.to(card), p),
                                   x.to(card), cfg)
    torch.testing.assert_close(got_y.cpu(), want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_aux.cpu(), want_aux, atol=1e-6,
                               rtol=1e-5)


def test_moe_paged_decode_step_on_the_card_matches_the_cpu(card):
    """The MoE arm of ``paged_decode_step`` through the paged kernel on the
    card against the plain arm on the CPU, fp32, 6 steps."""
    from repro_torch.models import transformer as M
    from repro_torch.serving import (PageAllocator, PagedCacheSpec,
                                     init_pages, paged_decode_step)
    cfg = _moe_cfg()
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    dparams = T.tree_map(lambda t: t.to(card), params)
    spec = PagedCacheSpec.for_config(cfg, num_slots=2, page_size=4,
                                     max_seq=16)
    alloc = PageAllocator(spec)
    for s in range(2):
        alloc.ensure(s, spec.seq_capacity)
    table = torch.tensor(alloc.tables)
    pages = {"cpu": init_pages(spec), "cuda": init_pages(spec, card)}
    active = torch.tensor([True, True])
    rng = np.random.default_rng(2)
    for t in range(6):
        tok = torch.tensor(rng.integers(cfg.vocab_size, size=(2, 1)))
        pos = torch.tensor([t, t + 3], dtype=torch.int32)
        want, pages["cpu"] = paged_decode_step(
            params, pages["cpu"], table, tok, pos, active, cfg)
        before = pa_ops.paged_attention.launches
        got, pages["cuda"] = paged_decode_step(
            dparams, pages["cuda"], table.to(card), tok.to(card),
            pos.to(card), active.to(card), cfg, attn_impl="cuda")
        assert pa_ops.paged_attention.launches == before + cfg.num_layers
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the vlm and encdec families' shapes, and trace replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("what,shape,causal", [
    ("whisper encoder", (2, 1500, 8, 8, 64), False),
    ("llama-3.2-vision", (1, 512, 64, 8, 128), True)])
def test_flash_kernel_vlm_encdec_shapes(card, dtype, tol, what, shape,
                                        causal):
    b, s, h, kv, hd = shape
    g = torch.Generator(device=card).manual_seed(9)
    q = torch.randn(b, s, h, hd, generator=g, device=card).to(dtype)
    k = torch.randn(b, s, kv, hd, generator=g, device=card).to(dtype)
    v = torch.randn(b, s, kv, hd, generator=g, device=card).to(dtype)
    got = fa_ops.flash_attention(q, k, v, causal=causal).float()
    want = flash_attention_ref(q, k, v, causal=causal).float()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_vlm_encdec_prefill_step_kernel_arm_matches_plain_arm(card, arch):
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as M
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    params = M.init_params(torch.Generator(device=card).manual_seed(0), cfg)
    shape = InputShape("p", 24, 2, "prefill")
    batch = {"tokens": torch.randint(cfg.vocab_size, (2, 24), device=card)}
    batch.update(S.modality_inputs(cfg, (2,), seed=1, device=card))
    want = S.make_prefill_step(cfg, shape)(params, batch)
    before = fa_ops.flash_attention.launches
    got = S.make_prefill_step(cfg, shape, attn_impl="cuda")(params, batch)
    attn = (cfg.encoder_layers + cfg.num_layers if cfg.arch_type == "encdec"
            else cfg.num_layers - cfg.num_layers // cfg.cross_attn_every)
    assert fa_ops.flash_attention.launches == before + attn
    for a, b in zip(T.leaves(got), T.leaves(want)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_trace_replay_on_the_card_matches_the_cpu(card):
    from repro_torch.exec import EventTrace
    cfgs = {"cuda": C.get_cnn_smoke_config("lenet"),
            "cpu": dataclasses.replace(C.get_cnn_smoke_config("lenet"),
                                       conv_impl="lowering")}
    params = C.init_params(torch.Generator().manual_seed(0), cfgs["cpu"])
    trace = EventTrace.round_robin(3, 9, "delayed")
    out = {}
    for dev, cfg in cfgs.items():
        eng = Engine(lambda p, b, cfg=cfg: C.loss_fn(p, b, cfg),
                     strategy="trace-replay", trace=trace, lr=0.05,
                     momentum=0.3, device=dev,
                     update_impl="cuda" if dev == "cuda" else "torch")
        data = P.SyntheticImages(P.DataConfig(
            batch_size=8, image_size=cfg.image_size,
            channels=cfg.in_channels, num_classes=cfg.num_classes))
        before = lc_bwd.wgrad_cuda.launches
        p, _, losses = eng.run(params, init_momentum(params),
                               data.batches(9), steps=9)
        if dev == "cuda":
            assert lc_bwd.wgrad_cuda.launches == before + 9 * len(cfg.convs)
        out[dev] = (T.leaves(p), losses)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], atol=1e-4,
                               rtol=1e-4)
    for a, b in zip(*(out[d][0] for d in ("cuda", "cpu"))):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the conv-tile autotuner's candidates, footprint model and default tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_shape,w_shape,stride", [
    ((4, 23, 23, 3), (11, 11, 3, 96), 4),    # Cout 96 at BN 64: 32 masked
    ((2, 13, 13, 96), (5, 5, 96, 256), 1),   # Cout 256 at BN 96: 288 columns
    ((2, 9, 9, 256), (3, 3, 256, 384), 1),   # Cin 256 at BN 96 (dgrad)
    ((2, 12, 12, 8), (3, 3, 8, 70), 2)])     # ragged tiles, stride 2
def test_every_tile_candidate_matches_plain(card, x_shape, w_shape, stride):
    from repro_torch.kernels.lowering_conv import autotune
    g = torch.Generator(device=card).manual_seed(w_shape[3] + stride)
    x = torch.randn(x_shape, generator=g, device=card)
    w = torch.randn(w_shape, generator=g, device=card) * 0.1
    kh, kw = w_shape[:2]
    want_low = lower(x, kh, kw, stride)
    dy = None
    cands = autotune.tile_candidates(x_shape, w_shape, stride, device=card)
    dflt = lc_bwd.default_tiles(w_shape)
    assert sorted(cands["fwd"]) == sorted(cands["dgrad"]) == [64, 96]
    for bn in cands["fwd"]:
        t = dataclasses.replace(dflt, fwd_bn=bn)
        y, low = lowering_conv_cuda(x, w, stride=stride, return_lowered=True,
                                    tiles=t)
        _fp32_close(y, lowered_conv_ref(x, w, stride))
        assert torch.equal(low.reshape(want_low.shape), want_low)
        dy = torch.randn(y.shape, generator=g, device=card) if dy is None \
            else dy
    for bn, blocks in cands["wgrad"]:
        t = dataclasses.replace(dflt, wgrad_bn=bn, wgrad_blocks=blocks)
        dw = lc_bwd.wgrad_cuda(low, dy, w_shape, tiles=t)
        _fp32_close(dw, lc_bwd.wgrad_ref(want_low, dy, w_shape))
        assert torch.equal(lc_bwd.wgrad_cuda(low, dy, w_shape, tiles=t), dw)
    for bn in cands["dgrad"]:
        t = dataclasses.replace(dflt, dgrad_bn=bn)
        _fp32_close(lc_bwd.dgrad_cuda(dy, w, x_shape, stride=stride,
                                      tiles=t),
                    lc_bwd.dgrad_ref(dy, w, x_shape, stride))


def test_smem_model_matches_the_compiled_kernels(card):
    from repro_torch.kernels.lowering_conv import lowering_conv as lc
    for pass_ in ("fwd", "wgrad", "dgrad"):
        for bn in lc.BLOCK_N:
            assert lc.kernel_smem_bytes(pass_, bn) == \
                lc.smem_bytes(pass_=pass_, block_n=bn)
        assert lc.kernel_smem_bytes(pass_, 128) == -1


def test_kernels_refuse_an_unbuilt_width(card):
    x = torch.randn((2, 9, 9, 8), device=card)
    w = torch.randn((3, 3, 8, 16), device=card)
    import types
    # past ConvTiles' own check: the C entry refuses it
    with pytest.raises(RuntimeError, match="CUDA error"):
        lowering_conv_cuda(x, w, tiles=types.SimpleNamespace(fwd_bn=128))


@pytest.mark.parametrize("x_shape,w_shape,stride",
                         C.conv_layer_shapes(C.CAFFENET, 8),
                         ids=["conv1", "conv2", "conv3", "conv4", "conv5"])
def test_default_tiles_are_bitwise_the_untiled_launch(card, x_shape, w_shape,
                                                      stride):
    """A layer never probed runs ``DEFAULT_TILES``: the same bits as a
    launch that leaves the tiles out (the rule the kernels ran before the
    autotuner), through the model's own lookup too."""
    from repro_torch.kernels.lowering_conv import autotune
    autotune.clear_tile_cache()
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(x_shape, generator=g, device=card)
    w = torch.randn(w_shape, generator=g, device=card) * 0.05
    t = autotune.cached_tiles(x_shape, w_shape, stride, card)
    assert t == autotune.DEFAULT_TILES(w_shape)
    y, low = lowering_conv_cuda(x, w, stride=stride, return_lowered=True)
    yt, lowt = lowering_conv_cuda(x, w, stride=stride, return_lowered=True,
                                  tiles=t)
    assert torch.equal(y, yt) and torch.equal(low, lowt)
    dy = torch.randn(y.shape, generator=g, device=card)
    assert torch.equal(lc_bwd.wgrad_cuda(low, dy, w_shape),
                       lc_bwd.wgrad_cuda(low, dy, w_shape, tiles=t))
    assert torch.equal(lc_bwd.dgrad_cuda(dy, w, x_shape, stride=stride),
                       lc_bwd.dgrad_cuda(dy, w, x_shape, stride=stride,
                                         tiles=t))


def test_launcher_autotunes_and_traces_on_the_card(card, tmp_path):
    from repro_torch.kernels.lowering_conv import autotune
    from repro_torch.launch import train as TR
    from repro_torch.obs import validate
    autotune.clear_tile_cache()
    path = tmp_path / "t.json"
    losses = TR.main(["--arch", "caffenet", "--smoke", "--batch", "8",
                      "--groups", "2", "--steps", "3", "--trace-out",
                      str(path)])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert validate.check_trace(path, ["autotune.conv_tiles",
                                       "autotune.candidate", "engine.run",
                                       "engine.step"]) == []
    cfg = C.get_cnn_smoke_config("caffenet")
    for xs, ws, s in C.conv_layer_shapes(cfg, 4):
        assert autotune._cache_key(xs, ws, s, card) in autotune._TILE_CACHE
    autotune.clear_tile_cache()


# ---------------------------------------------------------------------------
# granite-4.0-h-small (hybrid_moe): the decode replay, the pre-scaled q
# ---------------------------------------------------------------------------

def _granite_cfg(dtype):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("granite-4.0-h-small"),
                               d_model=256, num_heads=4, num_kv_heads=2,
                               head_dim=64, compute_dtype=dtype,
                               attention_multiplier=1 / 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_granite_decode_replay_is_the_eager_step(card, dtype):
    """Every replay of the hybrid step (Mamba-2 state, paged attention,
    the dropless MoE's dense dispatch and its counters, the argmax) gives
    the eager step's logits, tokens and slot state bit for bit, run from
    the same state; every decode step is a replay. Every prefill, a replay
    of its shape's graph, gives the eager prefill's tokens, state and K/V
    bit for bit."""
    from repro_torch.obs.metrics import MetricRegistry
    cfg = _granite_cfg(dtype)
    reqs = _graph_reqs(cfg)
    reg = MetricRegistry()
    srv = ContinuousServer(cfg, slots=3, page_size=8, max_seq=64,
                           attn_impl="cuda", prefill_mode="parallel",
                           registry=reg, device=card)
    srv.warmup(sorted({len(r.prompt) for r in reqs}))
    graphed, seen = srv._step, []
    state = ("ssm_h", "ssm_conv")

    def step(table, tokens, pos, active, gather_pages):
        before = {k: srv.pages[k].clone() for k in state}
        got = graphed(table, tokens, pos, active, gather_pages)
        logits = srv._graph.logits.clone()
        after = {k: srv.pages[k].clone() for k in state}
        counted = {k: v.clone() for k, v in srv._moe_stats.items()}
        for k in state:
            srv.pages[k].copy_(before[k])
        want_logits, want = srv._decode(table, tokens, pos, active)
        for k in state:
            assert torch.equal(srv.pages[k], after[k]), (k, len(seen))
        assert torch.equal(logits, want_logits), len(seen)
        assert torch.equal(got, want), len(seen)
        for k, v in counted.items():
            srv._moe_stats[k].copy_(v)
        seen.append(int(active.sum()))
        return got

    lanes, shapes = srv._prefill_lanes, []
    pools = ("ssm_h", "ssm_conv", "k", "v")

    def prefill(table, prompts, act, admit):
        before = {k: srv.pages[k].clone() for k in pools}
        got = lanes(table, prompts, act, admit)
        after = {k: srv.pages[k].clone() for k in pools}
        for k in pools:
            srv.pages[k].copy_(before[k])
        srv._graphed = False
        want = lanes(table, prompts, act, admit)
        srv._graphed = True
        for k in pools:
            assert torch.equal(srv.pages[k], after[k]), (k, len(shapes))
        assert torch.equal(got, want), len(shapes)
        shapes.append((int(admit.sum()), prompts.shape[1]))
        return got

    srv._step = step
    srv._prefill_lanes = prefill
    rep = srv.run(reqs)
    assert len(rep.rids) == len(reqs)
    steps = len(reg.series("serving.decode_step_s").values)
    assert steps == len(seen) > 0 and min(seen) < 3 == max(seen)
    assert reg.counter("serving.decode_graph_replays").value == steps
    assert 0 < reg.gauge("serving.moe_live_share").value <= 1
    # the prefills replayed graphs of several shapes, in the order the
    # traffic asked for them, from one memory pool
    assert len(set(shapes)) > 1
    assert len(srv._prefill_graphs) >= len({s[1] for s in shapes})


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_prescaled_q_gives_the_configured_scale(card, dtype, tol):
    """B5 and B6 divide the scores by sqrt(hd): q multiplied by
    ``attention_multiplier * sqrt(hd)`` (as ``layers._project_qkv`` does)
    gives the softmax at Granite's scale 1/128, against plain attention
    at that scale."""
    import math
    mult, hd = 1 / 128, 128
    s = mult * math.sqrt(hd)
    g = torch.Generator(device=card).manual_seed(3)
    q = torch.randn(2, 40, 8, hd, generator=g, device=card).to(dtype)
    k = torch.randn(2, 40, 2, hd, generator=g, device=card).to(dtype)
    v = torch.randn(2, 40, 2, hd, generator=g, device=card).to(dtype)

    def plain(q, k, v, n):
        kk = k.float().repeat_interleave(4, dim=2)[:, :n]
        vv = v.float().repeat_interleave(4, dim=2)[:, :n]
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * mult
        qpos = torch.arange(q.shape[1], device=card) + n - q.shape[1]
        mask = torch.arange(n, device=card)[None, :] <= qpos[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vv)

    got = fa_ops.flash_attention(q * s, k, v, causal=True)
    torch.testing.assert_close(got.float(), plain(q, k, v, 40), atol=tol,
                               rtol=tol)
    qd, kp, vp, table, pos = _paged(card, dtype, pos=(5, 0, 63))
    got = pa_ops.paged_attention(qd * s, kp, vp, table, pos)
    for b in range(3):
        n = int(pos[b]) + 1
        kr = kp[table[b].long()].reshape(-1, 2, hd)[None]
        vr = vp[table[b].long()].reshape(-1, 2, hd)[None]
        want = plain(qd[b:b + 1], kr, vr, n)
        torch.testing.assert_close(got[b:b + 1].float(), want, atol=tol,
                                   rtol=tol)


# ---------------------------------------------------------------------------
# the Mamba-2 decode kernel
# ---------------------------------------------------------------------------

#: (slots, heads, P, N): granite-4.0-h-small's serving shapes, the smoke
#: configurations' (16, 8) and (16, 16), and the kernel's other row splits
#: (a row a lane at N = 4, ragged rows of 33 chunks, two chunks a lane)
SSM_SHAPES = [(32, 128, 64, 128), (5, 8, 16, 8), (5, 4, 16, 16),
              (3, 2, 5, 4), (3, 2, 7, 132), (3, 2, 64, 256)]


def _ssm_step(card, g, S, H, P, N, dtype, active):
    """One step's operands as ``ssm_decode`` hands them over: x, B, C
    views of one conv output, dt 0 on the inactive rows."""
    xbc = torch.randn(S, H * P + 2 * N, generator=g, device=card).to(dtype)
    x = xbc[:, :H * P].reshape(S, H, P)
    B, C = xbc[:, H * P:H * P + N], xbc[:, H * P + N:]
    dt = torch.nn.functional.softplus(
        torch.randn(S, H, generator=g, device=card) - 1.0)
    dt = torch.where(active[:, None], dt, 0.0)
    return x, B, C, dt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSM_SHAPES)
def test_ssm_decode_kernel_against_ref(card, shape, dtype):
    """Half the slots inactive, 4 steps chained: after every step the live
    rows' state within 1e-5 of the plain version's and their y within
    rtol 1e-4 (fp32 sums in another order; bf16 y at the bf16 limit), the
    inactive rows' state bit for bit what it was and their y 0; a second
    launch from the same state gives the same bits; one launch a call."""
    from repro_torch.kernels.ssm_decode import ops as sd_ops
    from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref
    S, H, P, N = shape
    g = torch.Generator(device=card).manual_seed(sum(shape))
    active = torch.arange(S, device=card) % 2 == 0
    live = active.nonzero()[:, 0]
    idle = (~active).nonzero()[:, 0]
    h = torch.randn(S, H, P, N, generator=g, device=card)
    want_h = h.clone()
    A = torch.linspace(1.0, 16.0, H, device=card)
    D = torch.rand(H, generator=g, device=card) + 0.5
    idle_h = h[idle].clone()
    ytol = (dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32
            else dict(atol=2e-2, rtol=2e-2))
    for step in range(4):
        x, B, C, dt = _ssm_step(card, g, S, H, P, N, dtype, active)
        again = h.clone()
        before = sd_ops.ssm_decode.launches
        y = sd_ops.ssm_decode(h, x, B, C, dt, A, D, active)
        assert sd_ops.ssm_decode.launches == before + 1
        want_y = ssm_decode_ref(want_h, x, B, C, dt, A, D)
        torch.cuda.synchronize()
        assert y.dtype == dtype and y.shape == (S, H, P)
        torch.testing.assert_close(h[live], want_h[live], atol=1e-5,
                                   rtol=1e-5, msg=f"state, step {step}")
        torch.testing.assert_close(y[live].float(), want_y[live].float(),
                                   **ytol, msg=f"y, step {step}")
        assert torch.equal(h[idle], idle_h), step
        assert not y[idle].any(), step
        assert torch.equal(sd_ops.ssm_decode(again, x, B, C, dt, A, D,
                                             active), y), step
        assert torch.equal(again, h), step


def test_ssm_decode_kernel_without_a_mask_advances_every_row(card):
    """``active=None`` (``transformer.decode_step``'s ssm arm): every row
    live."""
    from repro_torch.kernels.ssm_decode import ops as sd_ops
    from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref
    S, H, P, N = 4, 8, 64, 128
    g = torch.Generator(device=card).manual_seed(1)
    h = torch.randn(S, H, P, N, generator=g, device=card)
    want_h = h.clone()
    x, B, C, dt = _ssm_step(card, g, S, H, P, N, torch.float32,
                            torch.ones(S, dtype=torch.bool, device=card))
    A = torch.linspace(1.0, 16.0, H, device=card)
    D = torch.ones(H, device=card)
    y = sd_ops.ssm_decode(h, x, B, C, dt, A, D)
    want_y = ssm_decode_ref(want_h, x, B, C, dt, A, D)
    torch.testing.assert_close(h, want_h, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(y, want_y, atol=1e-5, rtol=1e-4)


def test_granite_decode_replay_counts_its_ssm_launches(card):
    """The captured step holds one ``ssm_decode`` launch a Mamba layer, and
    every replay adds them to ``ssm_decode.launches``: over a served run
    the count grows by the Mamba layers times the replays."""
    from repro_torch.kernels.ssm_decode import ops as sd_ops
    cfg = _granite_cfg("bfloat16")
    n_mamba = sum(k == "mamba" for k in cfg.layer_kinds)
    reqs = _graph_reqs(cfg)
    srv = ContinuousServer(cfg, slots=3, page_size=8, max_seq=64,
                           attn_impl="cuda", prefill_mode="parallel",
                           device=card)
    srv.warmup(sorted({len(r.prompt) for r in reqs}))
    assert srv._graph.ssm_launches == n_mamba > 0
    before = sd_ops.ssm_decode.launches
    srv.run(reqs)
    replays = srv.registry.counter("serving.decode_graph_replays").value
    assert replays > 0
    assert sd_ops.ssm_decode.launches == before + replays * n_mamba
