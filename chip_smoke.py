#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases, each of which exits non-zero on failure (nothing is caught and
passed over, nothing falls back to the CPU):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: every kernel from its CUDA source in this checkout (in
   parallel, ``-Xptxas -v`` report printed), timed; then each library's
   SASS (``cuobjdump -sass``): the flash, paged-decode, lowering-conv,
   wgrad and dgrad libraries must hold ``HGMMA`` (wgmma) and ``UTMALDG``
   (TMA tile loads) and no ``HMMA`` (mma.sync), the counts printed;
3. kernels against their plain PyTorch versions at the serving path's
   shapes, bf16 (``atol = rtol = 2e-2``, and a relative RMS error within
   ``1e-2`` of the output's own RMS, which long-context outputs of small
   magnitude cannot pass on the absolute term) and fp32 (``1e-5``) — they
   differ only in summation order and, in bf16, in where the plain version
   rounds: paged decode at position 0, a page boundary, a full table, a
   wrapped ring, a stale retired row, every row at a full table (linear
   and wrapped ring), 256-slot pages whose short rows leave whole splits
   masked, and the Hopper kernel's edges (G = 16, 8-slot pages, 5-slot
   pages on its cp.async route, shares ending mid-tile, pos on a key
   tile's last slot, hd 32 and 64 at full tables; the kernel splits each
   row's keys over the blocks of one cluster, checked for the same bits
   on a second call), its shared memory a block equal to
   ``ops.smem_bytes`` at every head dim; flash attention causal at 256 (the
   served prefill bucket), 512 and 1024, windowed, ragged, and with per-row
   query offsets, then the bf16 tensor-core kernel's edges (hd 32 and 64,
   Sk off the 64-key tile, a window that skips leading tiles, Sq = 1 and
   a chunk at offsets, a window without causal masking); both kernels at
   G = 1 (qwen2-moe-a2.7b: 16 query heads on 16 kv heads), and flash
   attention at recurrentgemma-2b's local attention (hd 256, 10 query
   heads on one kv head, window 2048 at 2 x 4096, ragged at 2100, and a
   chunk at per-row offsets); the wgmma flash kernel's TMA boxes (Sk one
   key past a box at hd 128 and 256, hd 32's 64-byte swizzle), and its
   shared memory a block equal to ``ops.smem_bytes`` at every head dim;
4. kernel timings (CUDA events around device work only, L2 flushed before
   each launch) beside the plain version, one PyTorch library call
   computing the same function (timed here only; the port never calls
   it), and the card's bound; paged decode also with every row at a full
   table (its splits and cluster size printed beside), flash attention
   also at recurrentgemma-2b's prefill shapes; (4b) the Mamba-2 decode
   kernel at granite-4.0-h-small's serving shapes (32 slots, 128 heads of
   64 x 128, bf16 x) with 32 and with 12 slots live, checked against its
   plain version (live state within 1e-5, inactive state bitwise), timed
   beside the plain version and its bytes bound;
5. the slice at full width: ``ContinuousServer`` on qwen2-7b (28 layers,
   d_model 3584, bf16 weights made from a seed) with ``attn_impl="cuda"``
   serves Poisson requests twice — scan prefill, then parallel prefill —
   with the kernels' launch counts zeroed just before each run and
   checked just after against the run's own decode steps and prefills;
   then ``torch.profiler`` over full-width decode steps (device idle share
   and the kernels that take the device time; paged decode is one kernel
   a layer, and a combine kernel fails the phase);
6. slice parity: at qwen2-7b widths, 2 layers, fp32, ``attn_impl="cuda"``
   and ``"torch"`` agree within ``1e-4`` on the per-step logits of
   ``paged_decode_step`` and, for the server's parallel prefill, on the
   ``transformer.forward`` logits and on the pages
   ``ContinuousServer._parallel_prefill`` writes; then in bf16 (the path
   serving runs, through the tensor-core flash kernel) the
   ``transformer.forward`` logits of both arms against the fp32 forward of
   the same weights: the kernel arm no further from it than the plain arm
   (which rounds its scores to bf16) and within relative RMS ``2e-2``;
7. the CNN-training kernels (phases 3 and 4 also hold these): the fused
   update bitwise equal to its plain version (fp32 and bf16, CaffeNet's
   largest leaf and the slab of all 16 leaves, g = 4); the lowering-conv
   forward (its lowered residual bitwise), wgrad and dgrad at the five
   full-width CaffeNet layer shapes at group batch 64 (wgrad called twice
   for the same bits), plus two ragged dgrad tiles and a stride-2 dgrad,
   the forward (its residual bitwise) and wgrad at the same two ragged
   tiles, wgrad also at M no multiple of its 32-row stage and at M < 32,
   within ``1e-4 * max|want|`` abs and ``1e-5``
   relative RMS (fp32 sums over K <= 3456 or M <= 193,600 in another
   order than cuBLAS; all three in 3xTF32 on tensor cores);
   timed beside the plain versions and ``F.conv2d`` /
   ``torch.nn.grad.conv2d_weight`` / ``conv2d_input`` (channels-last fp32,
   TF32 off; timed here only);
8. the training slice at full width: ``Engine`` trains CaffeNet (227x227x3,
   1000 classes, 28.8 M fp32 params from a seed) on the synthetic image
   stream at batch 256 — g = 4 ``grouped-fused`` for 1 warm-up + 5 rounds,
   then g = 1 ``sync`` for 3 — through ``conv_impl="lowering_cuda"`` and
   ``update_impl="cuda"``, with the launch counts zeroed before each run
   and checked after it (per round: lowering_conv 5g, wgrad 5g, dgrad 4g,
   fused_update 16), every loss finite; then ``torch.profiler`` over one
   round (device idle share, the kernels that take the time);
9. training parity: at full CaffeNet widths, batch 8, g = 2, one round
   with the kernel arms and one with the plain arms (``lowering`` /
   ``torch``) agree within ``1e-4`` on the loss and all 16 updated leaves;
10. the multi-device engine (``engine.spmd``): (a) world size 1 over NCCL,
   ``Engine(exec_mode="spmd")`` trains full-width CaffeNet at batch 256,
   g = 1 ``sync``, 2 rounds, bitwise the ``exec_mode="reference"`` run of
   the same rounds (params, momentum, losses, per-shard losses); (b) four
   ranks sharing the card over gloo with CUDA tensors (spawned, a file
   rendezvous in a temporary directory) at (g, k, mp) = (4, 1, 1),
   (2, 2, 1) and (2, 1, 2), ``grouped-fused``, 2 rounds each: every rank
   bitwise the single-process reference of the same (g, k); both with the
   launch counts zeroed before each SPMD run and checked after it (per
   round and rank: lowering_conv 5, wgrad 5, dgrad 4, fused_update once
   per bucket) and every loss finite; (c) the bucket layout, the round
   times under gloo (a correctness run: gloo stages through the host),
   ``torch.cuda.device_count()``;
11. B1 once per bucket slab of that layout (g = 4), timed against its
   bytes bound;
12. LM training at full qwen2-7b width (d_model 3584, 28/4 heads, d_ff
   18944, vocab 152064; 2 of its 28 layers, the run's ``reduced`` list),
   fp32 params and momentum from seed 0 on the host, bf16 compute, remat
   on, the ``SyntheticLM`` stream: (a) ``Engine`` at g = 4
   ``grouped-fused``, lr 0.05, mu 0.3, batch 16 x seq 512, 1 warm-up + 3
   rounds with the launch counts zeroed before and checked after (B1 once
   a leaf a round, 15, and nothing else), every loss finite, round ms,
   tokens/s and peak memory beside the reckoned bytes, then
   ``torch.profiler`` over one round; (b) on that round's own (g, ...)
   gradient stacks, B1 bitwise its plain version on all 15 leaves and
   timed over them against its bytes bound; (c) ``exec_mode="spmd"`` over
   NCCL at world size 1, ``sync``, batch 4 x 512, 2 rounds, bitwise the
   ``"reference"`` run, and its bucket layout; (d)
   ``steps.make_train_step`` with ``grad_accum=2`` at batch 2 x seq 4096
   (``chunked_attention`` under autograd), 2 steps; ``make_prefill_step``
   through the flash kernel and the plain arm at 4 x 512, each held to the
   fp32 prefill as in phase 6; ``make_decode_step`` for 4 tokens from
   ``init_cache``;
13. the optimizer (``core.auto_optimizer``, ``cluster``, the engine as
   Runner), at full CaffeNet width: (a) ``Engine.profiled_spec`` of
   ``gpu-h100-sxm``, i.e. ``Engine.profile`` of the g = 4
   ``grouped-fused`` round at batch 256 (1 warm-up + 5 timed rounds, the
   card synchronized around each), in images/s beside phase 8's
   ``Engine.run`` reading and within a factor 1.5 of it; (b)
   ``launch/train.main`` in this process with ``--arch caffenet --batch
   256 --cluster-spec 2xgpu-g2.2xlarge,2xcpu-c4.4xlarge --plan`` for 5
   rounds (the plan: g = 4 at shares (93, 93, 35, 35), each group's batch
   wrap-filled to 93), its plan, round ms and images/s from its metrics
   sink, every loss finite, the HE x SE report against a plan calibrated
   from that stream, and a plan with the H100 at its measured images/s
   beside the cluster's nodes; then B2-B4 against their plain versions at
   the five layers at group batch 93, and B1 bitwise with the plan's
   weights (backbone and merged-FC head coefficients) on the slab of all
   16 leaves; (c) ``algorithm1`` over ``make_runner(cnn_classify(),
   strategy="grouped-fused")`` (12x12x1 images, K = 9, Cout = 8; its one
   conv is fed by data, so no dgrad) once with ``update_impl="cuda"`` and
   once with ``"torch"``: the same decisions; then over the ``delayed``
   Runner. Every run of (a)-(c) zeroes the launch counts just before it
   and reads them just after;
14. the MoE, SSM and hybrid families: (a) ``ContinuousServer`` on
   qwen2-moe-a2.7b at full published width and depth (24 layers, d_model
   2048, 16/16 heads of 128, 60 experts top-4 of width 1408 + 4 shared,
   vocab 151,936; bf16 weights from seed 0 drawn one layer at a time, the
   router fp32), phase 5's traffic with scan and with parallel prefill,
   launch counts checked per run (B6 once a layer a decode and
   scan-prefill step, B5 once a layer a parallel prefill), then a
   profiled decode step; (b) phase 6's fp32 checks at its width, 2
   layers; (c) ``launch/serve.serve`` on mamba2-2.7b (64 layers) and
   recurrentgemma-2b (26 layers) at full width and depth, bf16, batch 4 x
   prompt 64 + 16 generated, every step's logits finite, and at full width
   with 2 (3) layers in fp32 ``decode_step`` over the prompt against
   ``forward``'s last-position logits within ``1e-4``; (d)
   ``make_prefill_step`` on recurrentgemma-2b at full width, 3 layers,
   2 x 4096 (the window masks), through the flash kernel and the plain
   arm, each held to the fp32 prefill as in phase 12 (d); (e) ``Engine``
   at g = 4 ``grouped-fused``, 16 x 512 tokens, fp32 params from seed 0,
   bf16 compute, remat on, on qwen2-moe-a2.7b at 2 of 24 layers (1
   warm-up + 3 rounds), mamba2-2.7b at 2 of 64 and recurrentgemma-2b at 3
   of 26 (1 + 2 each; the cuts are the runs' ``reduced`` lists), B1 once
   a leaf a round, every loss finite, peak memory beside (4 + g)·P·4 B;
   on the MoE round's own gradient stacks B1 bitwise its plain version;
15. the vlm and encdec families: (a) whisper-base at full width and depth
   (6 + 6 layers, d_model 512, 8 heads of 64, vocab 51,865; fp32 params
   from seed 0, bf16 compute): ``make_prefill_step`` over 8 x 1500 stub
   audio frames (``steps.modality_inputs``, seed 0) and a 4-token prompt
   through the flash kernel (the encoder non-causal over the ragged 1500
   frames, 6 launches; the decoder causal, 6) and through the plain arm,
   each held to the fp32 prefill (the kernel arm finite and within 1.5x
   the plain arm's relative RMS error), the fp32 arms within ``1e-4`` on
   the logits and every cache leaf, then the cross K/V copied from that
   forward's cache into ``init_cache`` and 60 tokens generated (every
   step's logits finite) and a profiled decode step, then
   ``launch/serve.serve`` with zero cross caches, as the reference
   serves; (b) llama-3.2-vision-90b at full
   published width (d_model 8192, 64 query heads on 8 kv heads of 128,
   d_ff 28,672, vocab 128,256, a cross block every 5th layer) and 40 of
   its 100 layers (the run's ``reduced`` list; bf16 weights from seed 0,
   drawn a layer at a time): the prefill step at 4 x 512 text tokens +
   1024 stub image tokens a row through both arms as in (a) (B5 causal
   at G = 8, 32 launches), its peak memory, then a batch of 4 served,
   prompt 32 + 32 generated, with the image K/V copied from the forward's
   ``super.ck`` / ``cv`` into ``init_cache``'s tree, and a profiled
   decode step; the fp32 arms within ``1e-4`` at one super-block (5
   layers);
16. trace replay at full CaffeNet width, group batch 64:
   ``Engine(strategy="trace-replay")`` along a 32-commit ``queue_sim``
   trace (g = 4, exponential service) with ``scan``, and along
   ``EventTrace.round_robin(4, 32, "grouped")`` with ``fused`` and with
   ``scan`` (the two within ``1e-4`` on the losses and final params): ms
   a commit, the ring depth R, peak memory; launch counts zeroed before
   and checked after each run (per commit: lowering_conv 5, wgrad 5,
   dgrad 4, no fused update), every loss finite; then the ``queue_sim``
   replay profiled (``Engine.replay`` on the batches already on the
   card);
17. the conv-tile autotuner at full CaffeNet width, group batch 64: (a)
   every candidate tile of B2, B3 and B4 (``autotune.tile_candidates``:
   widths 64 and 96, wgrad's block targets) at the five layers against
   the plain versions at phase 7's limits (dgrad at layers 2-5), the
   residual bitwise; (b) ``lowering_conv.smem_bytes`` equal to each
   compiled kernel's ``<kernel>_smem_bytes`` for every pass and width;
   (c) ``models.cnn.autotune_conv_tiles(CAFFENET, 64)`` under a span
   tracer: each candidate's time, each layer's winner beside
   ``DEFAULT_TILES``, the probe's wall time; ``DEFAULT_TILES`` equal to
   the fixed rule recomputed here and bitwise the launches that leave the
   tiles out; each kernel over one group's five layers at the chosen and
   the default tiles; (d) ``launch/train.main`` on caffenet (batch 256,
   g = 4, 5 rounds, the tile cache empty) with ``--trace-out`` and
   ``--metrics-out``: the launcher probes, then trains; its launch counts
   (the rounds' and the probes', which the trace's candidate spans
   count) checked, the trace passing ``obs.validate`` with the autotune
   and engine spans, its round's ms beside phase 8's; then
   ``launch/params_util`` counts from meta params for every arch at full
   size, and the bytes reckoned for the runs phases 12, 14 and 15
   measured, beside their peaks (readings). Phase 13's launcher run finds
   its tiles probed before it, outside its counted run; every other phase
   runs the default tiles (the cache is emptied after phases 13 and 17);
18. the dry-run on meta tensors (``launch/dryrun.py``): (a) its host-smoke
   lane for llama3-405b, qwen2-moe-a2.7b and mamba2-2.7b on a (1, 4, 2)
   layout, one line each (a sharding or exchange regression raises);
   (b) qwen2-7b at full width, 2 layers, bf16 compute, remat:
   ``make_train_step`` at 16 x 512 counted by ``launch/meta_count`` on
   meta tensors and on the card, which must give the same integer FLOPs,
   the card's ``max_memory_allocated`` over the counted step beside the
   meta ``peak_per_chip_est``, the step's median time (CUDA events) beside
   the roofline; (c) a dense decode step of full-depth qwen2-7b at batch 8
   over a 1024-slot cache, FLOPs equal on meta and the card, its median
   wall beside the roofline's memory term. No port kernel runs in (b) or
   (c): their launch counts stay 0.

Then the ``kernels`` JSON line, the ``nvidia-smi`` name / power-limit line,
and last ``{"ok": true, "device": {...}}``. ``--kernels-only`` stops after
phase 4 (and its training half) and prints no final line; ``--spmd-nccl``
runs only phase 10 (b) over NCCL, one rank per card on a four-card
machine, and prints no final line.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_S = 3.35e12          # H100 SXM device memory
BF16_FLOP_S = 989e12           # H100 SXM dense bf16 tensor-core peak
FP32_FLOP_S = 67e12            # H100 SXM fp32, outside the tensor cores
TF32_FLOP_S = 495e12           # H100 SXM dense TF32 tensor-core peak
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
BF16_REL_RMS = 1e-2            # ~2.5 bf16 ulps of relative error, on average

PAGED = dict(B=8, K=4, G=7, hd=128, page=16, n_pages=64)   # qwen2-7b serving
FLASH = dict(B=8, H=28, K=4, hd=128)
RG_FLASH = (2, 10, 1, 256)     # recurrentgemma-2b prefill: (B, H, K, hd)
RG_WINDOW = 2048
WHISPER_FLASH = (8, 8, 8, 64)  # whisper-base, 8 x 30 s audio: (B, H, K, hd)
VISION_FLASH = (4, 64, 8, 128)  # llama-3.2-vision-90b prefill, 4 x 512
SPIN_CYCLES = 20_000_000       # ~10 ms at the H100's clock: covers any enqueue

#: peak device memory of the runs phase 17 reckons, by their log tags
PEAKS: dict = {}

CNN_GROUP_BATCH = 64           # CaffeNet batch 256 over g = 4 groups
CNN_BATCH, CNN_GROUPS = 256, 4
CONV_ABS, CONV_REL_RMS = 1e-4, 1e-5   # x max|want|; fp32 sums reordered


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, *, iters: int, warmup: int = 2, flush=None) -> float:
    """Median CUDA-event time of ``fn()`` in ms, device time only: a spin
    kernel queued before the start event keeps the card busy while the
    host enqueues ``fn``'s launches, so host overhead stays outside the
    events. ``flush`` (a large buffer) is overwritten before each launch,
    outside the timed span, so every launch finds L2 cold as it does
    between the layers of a decode step."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def compare(torch, name, got, want, dtype_name) -> float:
    tol = TOL[dtype_name]
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: kernel output is not finite")
    try:
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    except AssertionError as exc:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3g}, tol {tol}):\n{exc}")
    rel = ((got.float() - want.float()).norm()
           / want.float().norm().clamp_min(1e-30)).item()
    if dtype_name == "bfloat16" and rel > BF16_REL_RMS:
        fail(f"{name}: relative RMS error {rel:.3g} > {BF16_REL_RMS}")
    log(f"[check] {name}: max_abs_err={err:.3e} (tol {tol}) "
        f"rel_rms={rel:.3e} mean|want|={want.float().abs().mean().item():.3e}"
        " ok")
    return err


def bound(nbytes: float, flops: float, flop_s: float = BF16_FLOP_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare_fp32(torch, name, got, want) -> float:
    """Max abs error <= CONV_ABS * max|want| and relative RMS error <=
    CONV_REL_RMS; returns the max abs error."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    if err > CONV_ABS * scale or rel > CONV_REL_RMS:
        fail(f"{name}: kernel disagrees with its plain version: max abs err "
             f"{err:.3e} (limit {CONV_ABS * scale:.3e}), relative RMS "
             f"{rel:.3e} (limit {CONV_REL_RMS})")
    log(f"[check] {name}: max_abs_err={err:.3e} (limit {CONV_ABS:g} x "
        f"max|want| = {CONV_ABS * scale:.3e}) rel_rms={rel:.3e} ok")
    return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(torch) -> str:
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    lines = [x.strip() for x in smi.stdout.strip().splitlines()]
    for i, x in enumerate(lines):
        log(f"[env] nvidia-smi card {i}: {x}")
    return lines[0]


#: the libraries whose products must run on wgmma (SASS HGMMA) with tiles
#: brought by TMA (UTMALDG), and no mma.sync (HMMA)
WGMMA_LIBS = ("flash_attention", "paged_attention", "lowering_conv", "wgrad",
              "dgrad")
SASS_COUNTED = ("HGMMA", "UTMALDG", "HMMA")


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    log(f"[build] {len(libs)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs.values()))
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    counts = {}
    for name in WGMMA_LIBS:
        dump = subprocess.run([str(cuobjdump), "-sass", str(libs[name])],
                              capture_output=True, text=True, timeout=300)
        if dump.returncode:
            fail(f"cuobjdump -sass {libs[name].name} failed: "
                 f"{dump.stderr.strip()}")
        counts[name] = {op: dump.stdout.count(op) for op in SASS_COUNTED}
        missing = [op for op in ("HGMMA", "UTMALDG") if not counts[name][op]]
        if missing:
            fail(f"{name}'s SASS holds no {', '.join(missing)}: its products "
                 "must run on wgmma with tiles brought by TMA")
        if counts[name]["HMMA"]:
            fail(f"{name}'s SASS holds {counts[name]['HMMA']} HMMA "
                 "(mma.sync): no product of it may leave wgmma")
    log("[build] SASS " + json.dumps(counts))


def paged_inputs(torch, dtype, pos, *, stale=(), ring=False, seed=0,
                 **shape):
    """Pools, a page table (each row its own pages; columns past a linear
    row's live page point at scratch page 0, as the allocator leaves them)
    and positions at the serving path's shapes (``shape`` overrides
    ``PAGED``'s entries)."""
    shape = {**PAGED, **shape}
    B, K, G, hd, page, n = (shape[k] for k in
                            ("B", "K", "G", "hd", "page", "n_pages"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    P = 1 + B * n
    q = torch.randn(B, 1, K * G, hd, generator=g, device=dev).to(dtype)
    kp = torch.randn(P, page, K, hd, generator=g, device=dev).to(dtype)
    vp = torch.randn(P, page, K, hd, generator=g, device=dev).to(dtype)
    table = (torch.randperm(P - 1, generator=g, device=dev) + 1).view(B, n)
    table = table.to(torch.int32)
    for b, p in enumerate(pos):
        if not ring:
            table[b, min(p // page, n - 1) + 1:] = 0
    for b in stale:
        table[b] = 0
    return (q, kp, vp, table.contiguous(),
            torch.tensor(pos, dtype=torch.int32, device=dev))


def check_paged(torch) -> float:
    """B6 against its plain version, each case called twice for the same
    bits, and its shared memory a block against ``ops.smem_bytes``;
    returns the largest bf16 error."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    worst = 0.0
    W = PAGED["n_pages"] * PAGED["page"]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        cases = [
            # pos 0, page edge 15/16, full table, stale retired row 4
            ("linear", dict(pos=[0, 15, 16, W - 1, 900, 100, 517, 777],
                            stale=(4,)), None),
            # wrapped ring rows (pos >= W) and a stale retired row 7
            ("ring", dict(pos=[0, 15, W - 1, W, 1500, 2 * W - 1, 3000, 900],
                          stale=(7,), ring=True), W),
            # every row at a full table: all splits hold 4 key tiles
            ("full table", dict(pos=[W - 1 - 3 * b for b in range(8)]),
             None),
            ("full table ring", dict(pos=[W + 37 * b for b in range(8)],
                                     ring=True), W),
            # 256-slot pages, 4 splits of 4 key tiles: a row at pos 5 has
            # 4 live tiles, one a split, the last three all masked (their
            # weight exp(-1e30 - M) = 0)
            ("masked splits", dict(pos=[5, 70, 0, 200, 63, 64, 130, 1000],
                                   page=256, n_pages=4), None),
            ("masked splits ring", dict(pos=[5, 70, 0, 200, 63, 1500, 130,
                                             1000], ring=True, page=256,
                                        n_pages=4), W),
            # qwen2-moe-a2.7b: 16 kv heads of one query head each (G = 1)
            ("G=1 K=16", dict(pos=[0, 15, 16, W - 1, 900, 100, 517, 777],
                              stale=(4,), K=16, G=1), None),
            # the Hopper kernel's edges: 16 query heads a kv head, TMA
            # boxes of 8 slots, 5-slot pages (16-byte cp.async copies, no
            # TMA), shares ending mid-tile, pos on a key tile's last slot,
            # hd 32 (64-byte swizzle, 8 stages) and hd 64 at full tables
            ("G=16 K=2", dict(pos=[0, 64, 191, W - 1, 500, 7, 333, 1000],
                              K=2, G=16), None),
            ("page 8", dict(pos=[0, 7, 8, W - 1, 900, 100, 517, 777],
                            page=8, n_pages=128), None),
            ("page 5 ring", dict(pos=[0, 4, 5, 999, 1000, 1777, 2500, 321],
                                 ring=True, page=5, n_pages=200), 1000),
            ("page 5", dict(pos=[0, 4, 5, 999, 640, 100, 517, 777],
                            page=5, n_pages=200), None),
            ("shares end mid-tile", dict(pos=[100, 300, 540, 17, 211, 700,
                                              905, 45]), None),
            ("pos on a tile's last slot", dict(pos=[63, 127, 191, 255, 511,
                                                    767, 959, W - 1]),
             None),
            ("hd 32 full table", dict(pos=[W - 1 - 5 * b for b in range(8)],
                                      hd=32), None),
            ("hd 64 full table ring", dict(pos=[W + 11 * b for b in range(8)],
                                           ring=True, hd=64), W),
        ]
        for label, kw, window in cases:
            args = paged_inputs(torch, dtype, **kw)
            got = pa.paged_attention(*args, window=window)
            want = paged_attention_ref(*args, window=window)
            e = compare(torch, f"paged_attention {label} {dn}", got, want, dn)
            if not torch.equal(pa.paged_attention(*args, window=window), got):
                fail(f"paged_attention {label} {dn}: a second call gave "
                     "other bits (the splits must combine in a fixed order)")
            if dtype is torch.bfloat16:
                worst = max(worst, e)
    for dtype in pa.DTYPES:
        for hd in pa.HEAD_DIMS:
            if pa.kernel_smem_bytes(dtype, hd) != pa.smem_bytes(dtype, hd):
                fail(f"paged_attention {dtype} hd {hd}: the kernel asks for "
                     f"{pa.kernel_smem_bytes(dtype, hd)} bytes of shared "
                     f"memory, the model says {pa.smem_bytes(dtype, hd)}")
    log("[check] paged_attention shared memory a block (bf16 / fp32 by hd): "
        + ", ".join(f"{hd}: {pa.smem_bytes(torch.bfloat16, hd)} / "
                    f"{pa.smem_bytes(torch.float32, hd)}"
                    for hd in pa.HEAD_DIMS) + " = the kernel's own figures ok")
    return worst


def phase_check(torch) -> dict:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    errs = {"paged_attention": check_paged(torch), "flash_attention": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        B, H, K, hd = (FLASH[k] for k in ("B", "H", "K", "hd"))
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(1)
        offs = torch.randint(0, 1024, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        for label, sq, sk, kw in (
                ("causal 256", 256, 256, {}),
                ("causal 512", 512, 512, {}),
                ("causal 1024", 1024, 1024, {}),
                ("window 256 at 512", 512, 512, {"window": 256}),
                ("ragged 200", 200, 200, {}),
                ("q_offsets decode 1x1024", 1, 1024, {"q_offsets": offs}),
                ("q_offsets chunk 64x1024", 64, 1024,
                 {"q_offsets": offs.clamp(max=1024 - 64)})):
            q = torch.randn(B, sq, H, hd, generator=g, device=dev).to(dtype)
            k = torch.randn(B, sk, K, hd, generator=g, device=dev).to(dtype)
            v = torch.randn(B, sk, K, hd, generator=g, device=dev).to(dtype)
            got = fa.flash_attention(q, k, v, causal=True, **kw)
            want = flash_attention_ref(q, k, v, causal=True, **kw)
            e = compare(torch, f"flash_attention {label} {dn}", got, want, dn)
            if dtype is torch.bfloat16:
                errs["flash_attention"] = max(errs["flash_attention"], e)
            del q, k, v, got, want
        # the bf16 tensor-core kernel's edges (fp32 runs the same cases on
        # its CUDA-core kernel): head dims 32 and 64, Sk not a multiple of
        # the 64-key tile, a window that skips leading tiles, Sq = 1 and a
        # short chunk at per-row offsets, a one-sided window without causal
        for label, (b, h, kv, d), sq, sk, kw in (
                ("hd32 causal 256", (2, 8, 2, 32), 256, 256, {}),
                ("hd64 causal 300", (2, 8, 2, 64), 300, 300, {}),
                ("hd64 q_offsets chunk 100x300", (2, 8, 2, 64), 100, 300,
                 {"q_offsets": (0, 200)}),
                ("hd32 q_offsets decode 1x777", (4, 8, 4, 32), 1, 777,
                 {"q_offsets": (0, 776)}),
                ("window 64 at 1024", (B, H, K, hd), 1024, 1024,
                 {"window": 64}),
                ("non-causal window 100 at 333", (2, 8, 2, hd), 333, 333,
                 {"causal": False, "window": 100}),
                # qwen2-moe-a2.7b's parallel prefill: G = 1
                ("G=1 H=K=16 causal 256", (8, 16, 16, 128), 256, 256, {}),
                # recurrentgemma-2b's local attention: hd 256, 10 query
                # heads on one kv head, window 2048 at 4096 (and ragged)
                ("hd256 G=10 window 2048 at 4096", RG_FLASH, 4096, 4096,
                 {"window": 2048}),
                ("hd256 G=10 window 2048 ragged 2100", RG_FLASH, 2100,
                 2100, {"window": 2048}),
                ("hd256 G=10 q_offsets chunk 100x3000", RG_FLASH, 100, 3000,
                 {"window": 2048, "q_offsets": (0, 2900)}),
                # whisper-base's encoder: non-causal over 1500 frames (off
                # both tiles), hd 64, G = 1; its decoder's causal prompt
                ("hd64 G=1 non-causal ragged 1500", WHISPER_FLASH, 1500,
                 1500, {"causal": False}),
                ("hd64 G=1 causal 4", WHISPER_FLASH, 4, 4, {}),
                # llama-3.2-vision-90b's self blocks: 64 query heads on 8
                # kv heads of 128
                ("hd128 G=8 H=64 causal 512", VISION_FLASH, 512, 512, {}),
                # the wgmma kernel's TMA boxes: Sk one key past a box of
                # keys (128, or 64 at hd 256), hd 32's 64-byte swizzle
                ("hd128 non-causal Sk one past a box 129", (2, 8, 2, 128),
                 129, 129, {"causal": False}),
                ("hd256 G=10 Sk one past a box 65", RG_FLASH, 65, 65, {}),
                ("hd32 non-causal ragged 200", (2, 8, 2, 32), 200, 200,
                 {"causal": False})):
            if "q_offsets" in kw:
                lo, hi = kw["q_offsets"]
                kw = dict(kw, q_offsets=torch.randint(
                    lo, hi + 1, (b,), generator=g, device=dev,
                    dtype=torch.int32))
            kw = {"causal": True, **kw}
            q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(b, sk, kv, d, generator=g, device=dev).to(dtype)
            v = torch.randn(b, sk, kv, d, generator=g, device=dev).to(dtype)
            got = fa.flash_attention(q, k, v, **kw)
            want = flash_attention_ref(q, k, v, **kw)
            e = compare(torch, f"flash_attention {label} {dn}", got, want, dn)
            if dtype is torch.bfloat16:
                errs["flash_attention"] = max(errs["flash_attention"], e)
            del q, k, v, got, want
    for dtype in fa.DTYPES:
        for hd in fa.HEAD_DIMS:
            if fa.kernel_smem_bytes(dtype, hd) != fa.smem_bytes(dtype, hd):
                fail(f"flash_attention {dtype} hd {hd}: the kernel asks for "
                     f"{fa.kernel_smem_bytes(dtype, hd)} bytes of shared "
                     f"memory, the model says {fa.smem_bytes(dtype, hd)}")
    log("[check] flash_attention shared memory a block (bf16 / fp32 by hd): "
        + ", ".join(f"{hd}: {fa.smem_bytes(torch.bfloat16, hd)} / "
                    f"{fa.smem_bytes(torch.float32, hd)}"
                    for hd in fa.HEAD_DIMS) + " = the kernel's own figures ok")
    return errs


def phase_time(torch) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                         valid_mask)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    out = {}

    # paged decode at the serving run's contexts (64..288 live tokens)
    B, K, G, hd, page, n = (PAGED[k] for k in
                            ("B", "K", "G", "hd", "page", "n_pages"))
    rng = torch.Generator().manual_seed(2)
    pos = torch.randint(64, 288, (B,), generator=rng).tolist()
    q, kp, vp, table, posd = paged_inputs(torch, torch.bfloat16, pos, seed=3)
    W = n * page
    ck = kp[table.long()].reshape(B, W, K, hd).transpose(1, 2).contiguous()
    cv = vp[table.long()].reshape(B, W, K, hd).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    mask = valid_mask(posd, W, None)[:, None, None, :].contiguous()
    tokens = sum(p + 1 for p in pos)
    nbytes = (2 * tokens * K * hd * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + B * 4)
    flops = 4 * G * K * hd * tokens
    ms = cuda_ms(torch, lambda: pa.paged_attention(q, kp, vp, table, posd),
                 iters=50, flush=flush)
    plain = cuda_ms(torch, lambda: paged_attention_ref(q, kp, vp, table, posd),
                    iters=20, flush=flush)
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, ck, cv, attn_mask=mask, enable_gqa=True), iters=50, flush=flush)
    b_ms, b_by = bound(nbytes, flops)
    out["paged_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                  bound_ms=b_ms, bound_by=b_by)
    S = pa.paged_splits(B, K, n, page)
    log(f"[time] paged_attention bf16 B={B} K={K} G={G} hd={hd} page={page} "
        f"live_tokens={tokens} splits={S} cluster=(1, 1, {S}) ring_stages="
        f"{pa.bf16_stages(hd)}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
        f"library_ms={lib:.4f} (SDPA enable_gqa over the {W}-slot gathered "
        f"copy) bound_ms={b_ms:.5f} ({b_by})")
    # the split rule's reason: the clusters the card holds at once, and the
    # time at twice the blocks (clusters of 8 at the serving shapes)
    clusters = _build.load(pa.KERNEL).paged_attention_max_clusters
    clusters.argtypes, clusters.restype = [ctypes.c_int] * 4, ctypes.c_int
    target = pa.SPLIT_TARGET_BLOCKS
    try:
        pa.SPLIT_TARGET_BLOCKS = 2 * target
        S2 = pa.paged_splits(B, K, n, page)
        ms2 = cuda_ms(torch, lambda: pa.paged_attention(q, kp, vp, table, posd),
                      iters=50, flush=flush)
    finally:
        pa.SPLIT_TARGET_BLOCKS = target
    log(f"[time] paged_attention split rule: splits={S} -> {B * K} clusters, "
        f"{clusters(B, K, S, hd)} fit at once, kernel_ms={ms:.4f}; at twice "
        f"the blocks splits={S2} -> {B * K} clusters, "
        f"{clusters(B, K, S2, hd)} fit at once, kernel_ms={ms2:.4f}")
    del q, kp, vp, ck, cv

    # paged decode with every row at a full table (the longest page walk)
    pos = [W - 1 - 3 * b for b in range(B)]
    q, kp, vp, table, posd = paged_inputs(torch, torch.bfloat16, pos, seed=5)
    ck = kp[table.long()].reshape(B, W, K, hd).transpose(1, 2).contiguous()
    cv = vp[table.long()].reshape(B, W, K, hd).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    mask = valid_mask(posd, W, None)[:, None, None, :].contiguous()
    tokens = sum(p + 1 for p in pos)
    ms = cuda_ms(torch, lambda: pa.paged_attention(q, kp, vp, table, posd),
                 iters=50, flush=flush)
    plain = cuda_ms(torch, lambda: paged_attention_ref(q, kp, vp, table, posd),
                    iters=20, flush=flush)
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, ck, cv, attn_mask=mask, enable_gqa=True), iters=50, flush=flush)
    b_ms, b_by = bound(2 * tokens * K * hd * 2 + 2 * q.numel() * 2
                       + table.numel() * 4 + B * 4, 4 * G * K * hd * tokens)
    log(f"[time] paged_attention bf16 full table B={B} live_tokens={tokens} "
        f"splits={S} cluster=(1, 1, {S}): kernel_ms={ms:.4f} plain_ms="
        f"{plain:.4f} library_ms={lib:.4f} (SDPA enable_gqa, gathered copy) "
        f"bound_ms={b_ms:.5f} ({b_by})")
    del q, kp, vp, ck, cv

    # flash prefill at the serving run's largest bucket (and at 1024)
    B, H, K, hd = (FLASH[k] for k in ("B", "H", "K", "hd"))
    g = torch.Generator(device="cuda").manual_seed(4)
    for S in (256, 1024):
        q = torch.randn(B, S, H, hd, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, S, K, hd, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, S, K, hd, generator=g, device="cuda").bfloat16()
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        flops = 4 * B * H * hd * pairs
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True),
                     iters=20, flush=flush)
        plain = cuda_ms(torch, lambda: flash_attention_ref(q, k, v,
                                                           causal=True),
                        iters=5, flush=flush)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True), iters=20,
            flush=flush)
        b_ms, b_by = bound(nbytes, flops)
        log(f"[time] flash_attention bf16 causal B={B} H={H} K={K} hd={hd} "
            f"Sq=Sk={S}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} (SDPA is_causal enable_gqa) "
            f"bound_ms={b_ms:.5f} ({b_by}) "
            f"achieved={flops / ms / 1e9:.1f} TFLOP/s")
        if S == 256:
            out["flash_attention"] = dict(ms=ms, plain_ms=plain,
                                          library_ms=lib, bound_ms=b_ms,
                                          bound_by=b_by)
        del q, k, v, qh, kh, vh

    # flash prefill at recurrentgemma-2b's shapes: hd 256, 10 query heads
    # on one kv head, window 2048, 2 x 4096
    B, H, K, hd = RG_FLASH
    S, Wn = 4096, RG_WINDOW
    q = torch.randn(B, S, H, hd, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, S, K, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, S, K, hd, generator=g, device="cuda").bfloat16()
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pos = torch.arange(S, device="cuda")
    band = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] > pos[:, None] - Wn))[None, None]
    pairs = int(band.sum())
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4 * B * H * hd * pairs
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True,
                                                   window=Wn),
                 iters=20, flush=flush)
    plain = cuda_ms(torch, lambda: flash_attention_ref(q, k, v, causal=True,
                                                       window=Wn),
                    iters=5, flush=flush)
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=band, enable_gqa=True), iters=20, flush=flush)
    b_ms, b_by = bound(nbytes, flops)
    log(f"[time] flash_attention bf16 causal window {Wn} B={B} H={H} K={K} "
        f"hd={hd} Sq=Sk={S} ({pairs} live pairs a head): kernel_ms={ms:.4f} "
        f"plain_ms={plain:.4f} library_ms={lib:.4f} (SDPA enable_gqa, the "
        f"band as a boolean mask) bound_ms={b_ms:.5f} ({b_by}) "
        f"achieved={flops / ms / 1e9:.1f} TFLOP/s")
    del q, k, v, qh, kh, vh, band

    # the vlm and encdec prefills: whisper-base's encoder (non-causal over
    # 1500 frames) and llama-3.2-vision-90b's self blocks (causal, G = 8)
    for label, (B, H, K, hd), S, causal in (
            ("non-causal", WHISPER_FLASH, 1500, False),
            ("causal", VISION_FLASH, 512, True)):
        q = torch.randn(B, S, H, hd, generator=g, device="cuda").bfloat16()
        k = torch.randn(B, S, K, hd, generator=g, device="cuda").bfloat16()
        v = torch.randn(B, S, K, hd, generator=g, device="cuda").bfloat16()
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2 if causal else S * S
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        flops = 4 * B * H * hd * pairs
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                       causal=causal),
                     iters=20, flush=flush)
        plain = cuda_ms(torch, lambda: flash_attention_ref(q, k, v,
                                                           causal=causal),
                        iters=5, flush=flush)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=True), iters=20,
            flush=flush)
        b_ms, b_by = bound(nbytes, flops)
        log(f"[time] flash_attention bf16 {label} B={B} H={H} K={K} hd={hd} "
            f"Sq=Sk={S}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} (SDPA enable_gqa) bound_ms={b_ms:.5f} "
            f"({b_by}) achieved={flops / ms / 1e9:.1f} TFLOP/s")
        del q, k, v, qh, kh, vh
    del flush
    torch.cuda.empty_cache()
    return out


def _drive(torch, srv, reqs, mode: str, tag: str = "slice") -> dict:
    """One served run with both launch counts zeroed just before it; the
    counts read just after must match the run's own steps and prefills."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.obs import spans
    L = srv.cfg.num_layers
    tracer = spans.Tracer()
    pa.paged_attention.launches = 0
    fa.flash_attention.launches = 0
    with spans.install(tracer):
        rep = srv.run(reqs)
    torch.cuda.synchronize()
    n_pa = pa.paged_attention.launches
    n_fa = fa.flash_attention.launches
    recs = tracer.records()
    steps = sum(1 for r in recs if r.name == "serve.decode_step")
    buckets = [r.attrs["bucket"] for r in recs if r.name == "serve.prefill"]
    if mode == "scan":
        want_pa, want_fa = L * (steps + sum(buckets)), 0
    else:
        want_pa, want_fa = L * steps, L * len(buckets)
    log(f"[{tag}:{mode}] decode_steps={steps} prefills={buckets} "
        f"paged_attention.launches={n_pa} (want {want_pa}) "
        f"flash_attention.launches={n_fa} (want {want_fa})")
    if (n_pa, n_fa) != (want_pa, want_fa):
        fail(f"{mode} run: launch counts {(n_pa, n_fa)} != {(want_pa, want_fa)}")
    if n_pa == 0 or (mode == "parallel" and n_fa == 0):
        fail(f"{mode} run launched a kernel of the path no time")
    if len(rep.rids) != len(reqs):
        fail(f"{mode} run finished {len(rep.rids)} of {len(reqs)} requests")
    if rep.total_tokens != sum(r.gen for r in reqs):
        fail(f"{mode} run: {rep.total_tokens} tokens != sum of gens")
    vocab = srv.cfg.vocab_size
    for r in reqs:
        t = rep.tokens[r.rid]
        if len(t) != r.gen or t.min() < 0 or t.max() >= vocab:
            fail(f"{mode} run: request {r.rid} tokens malformed: {t}")
    step_ms = [1e3 * v for v in
               srv.registry.series("serving.decode_step_s").values]
    log(f"[{tag}:{mode}] {len(rep.rids)} reqs {rep.total_tokens} tok in "
        f"{rep.makespan:.3f} s: {rep.throughput:.1f} tok/s "
        f"p50={rep.percentile(50) * 1e3:.1f} ms "
        f"p99={rep.percentile(99) * 1e3:.1f} ms "
        f"decode_step_ms median={statistics.median(step_ms):.2f} "
        f"min={min(step_ms):.2f} max={max(step_ms):.2f} "
        f"occupancy={rep.occupancy_mean:.2f}")
    return {"rep": rep, "paged": n_pa, "flash": n_fa}


def log_port_kernels(kernels, names) -> None:
    """The profile's rows of the port's own kernels, by name, whether or
    not they are among the largest (wgrad and the split conv forward run
    beside a prologue and a slice sum of their own)."""
    for ms, n, name in kernels:
        if any(k in name for k in names):
            log(f"[profile]   port kernel {ms:8.3f} ms  x{n:<6.0f} "
                f"{name[:100]}")


def _profile_fn(torch, fn, what: str, names, reps: int = 3) -> list:
    """``fn()`` (ending in a host read) ``reps`` times: wall a call on the
    host clock (no profiler), device busy time (the sum of kernel times
    under ``torch.profiler``), the device's idle share and the kernels
    that take the time (the port's ``names`` whether or not among them).
    Returns the kernels as (ms a call, launches a call, name)."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                                    # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kernels.append((us / reps / 1e3, e.count / reps, e.key))
    busy = sum(k[0] for k in kernels)
    kernels.sort(reverse=True)
    log(f"[profile] {what}: wall {wall_ms:.2f} ms (host clock, no "
        f"profiler), device busy {busy:.2f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}, {sum(k[1] for k in kernels):.0f} "
        "kernels a call")
    for ms, n, name in kernels[:8]:
        log(f"[profile]   {ms:8.3f} ms  x{n:<6.0f} {name[:80]}")
    log_port_kernels(kernels, names)
    return kernels


def phase_profile(torch, srv, steps: int = 5,
                  what: str = "full-width decode step") -> None:
    """Full-width decode steps (8 active slots at ~200-token contexts):
    wall time per step on the host clock (no profiler), device busy time
    per step (the sum of kernel times under ``torch.profiler``), the
    device's idle share, and the kernels that take the device time."""
    import numpy as np
    S = srv.spec.num_slots
    for s in range(S):
        srv.alloc.ensure(s, 256)
    dev = srv.device
    table = torch.tensor(srv.alloc.tables, device=dev)
    tok = torch.zeros((S, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor(np.arange(S, dtype=np.int32) * 7 + 180, device=dev)
    act = torch.ones((S,), dtype=torch.bool, device=dev)

    def step():
        return srv._step(table, tok, pos, act, None).cpu()

    kernels = _profile_fn(torch, step, f"{what}, 8 active slots",
                          ("paged_decode", "flash_fwd"), reps=steps)
    # B6 is one kernel a layer: the splits combine inside their cluster
    if any("combine" in name for _, _, name in kernels):
        fail(f"{what}: a combine kernel ran beside paged decode")
    if not any("paged_decode" in name for _, _, name in kernels):
        fail(f"{what}: no paged_decode kernel in the profile")
    for s in range(S):
        srv.alloc.release(s)


#: granite-4.0-h-small's Mamba-2 decode shapes in its served cell: slots,
#: heads, head channels P, state size N (x, B, C in bf16)
SSM_DECODE = dict(S=32, H=128, P=64, N=128)
SSM_LIVE = (32, 12)            # all slots live; the cell's ~12 (Little's law)


def phase_ssm_decode(torch) -> dict:
    """(4b) The Mamba-2 decode kernel at ``SSM_DECODE`` with ``SSM_LIVE``
    live slots (the others inactive): checked against its plain version
    (live state within 1e-5, live y at the bf16 limit, inactive state
    bitwise and y 0), then timed alone (L2 flushed, medians) beside the
    plain version and its bytes bound: each live slot's fp32 state read
    and written once, with its x, B, C and dt, and every slot's y."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssm_decode import ops as sd
    from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref
    S, H, P, N = (SSM_DECODE[k] for k in ("S", "H", "P", "N"))
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    h0 = torch.randn(S, H, P, N, generator=g, device=dev)
    xbc = torch.randn(S, H * P + 2 * N, generator=g, device=dev).bfloat16()
    x = xbc[:, :H * P].reshape(S, H, P)
    B, C = xbc[:, H * P:H * P + N], xbc[:, H * P + N:]
    raw = F.softplus(torch.randn(S, H, generator=g, device=dev) - 1.0)
    A = torch.linspace(1.0, 16.0, H, device=dev)
    D = torch.rand(H, generator=g, device=dev) + 0.5
    out = {}
    for live in SSM_LIVE:
        active = torch.arange(S, device=dev) < live
        dt = torch.where(active[:, None], raw, 0.0)
        h, want_h = h0.clone(), h0.clone()
        y = sd.ssm_decode(h, x, B, C, dt, A, D, active)
        want_y = ssm_decode_ref(want_h, x, B, C, dt, A, D)
        torch.cuda.synchronize()
        err = compare(torch, f"ssm_decode state, {live} of {S} live",
                      h[:live], want_h[:live], "float32")
        compare(torch, f"ssm_decode y, {live} of {S} live", y[:live],
                want_y[:live], "bfloat16")
        if not (torch.equal(h[live:], h0[live:]) and not y[live:].any()):
            fail(f"ssm_decode: an inactive slot's state changed or its y is "
                 f"not 0 ({live} of {S} live)")
        ms = cuda_ms(torch, lambda: sd.ssm_decode(h, x, B, C, dt, A, D,
                                                  active),
                     iters=50, flush=flush)
        plain = cuda_ms(torch, lambda: ssm_decode_ref(want_h, x, B, C, dt, A,
                                                      D),
                        iters=20, flush=flush)
        nbytes = live * (H * P * N * 8 + H * P * 2 + 2 * N * 2 + H * 4) \
            + S * H * P * 2
        b_ms, b_by = bound(nbytes, live * H * P * N * 6, FP32_FLOP_S)
        out[live] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=err)
        log(f"[time] ssm_decode bf16 x S={S} H={H} P={P} N={N} live={live}: "
            f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b_ms:.5f} "
            f"({b_by}, {nbytes / 1e6:.1f} MB) = {100 * b_ms / ms:.1f}% of "
            f"the bound, {nbytes / ms / 1e6:.0f} GB/s")
    del flush, h0, h, want_h
    return out


def phase_slice(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.serving import (ContinuousServer, poisson_trace,
                                     sample_requests)
    cfg = get_config("qwen2-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kw = dict(slots=8, page_size=16, max_seq=1024, attn_impl="cuda",
              device="cuda", seed=0)
    srv = ContinuousServer(cfg, **kw)
    torch.cuda.synchronize()

    def leaves(t):
        return [x for v in t.values()
                for x in (leaves(v) if isinstance(v, dict) else [v])]

    wbytes = sum(x.numel() * x.element_size() for x in leaves(srv.params))
    pbytes = sum(x.numel() * x.element_size() for x in srv.pages.values())
    log(f"[slice] qwen2-7b {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size}: weights {wbytes / 1e9:.2f} GB, page pool "
        f"{pbytes / 1e9:.3f} GB, made in {time.perf_counter() - t0:.1f} s")
    reqs = sample_requests(poisson_trace(2.0, 8, seed=0), cfg,
                           prompt_range=(64, 256), gen_range=(16, 32), seed=0)
    lens = [len(r.prompt) for r in reqs]
    log(f"[slice] 8 Poisson requests (2 req/s): prompts {lens} gens "
        f"{[r.gen for r in reqs]}")
    t0 = time.perf_counter()
    srv.warmup(lens)
    log(f"[slice] warmup {time.perf_counter() - t0:.1f} s")
    scan = _drive(torch, srv, reqs, "scan")
    params = srv.params
    del srv
    torch.cuda.empty_cache()
    par_srv = ContinuousServer(cfg, params, prefill_mode="parallel", **kw)
    par_srv.warmup(lens)
    par = _drive(torch, par_srv, reqs, "parallel")
    same = sum(int((scan["rep"].tokens[r.rid] == par["rep"].tokens[r.rid]
                    ).sum()) for r in reqs)
    log(f"[slice] scan vs parallel prefill: {same}/{scan['rep'].total_tokens}"
        " generated tokens equal (bf16; not required to be bitwise)")
    phase_profile(torch, par_srv)
    log(f"[slice] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del par_srv, params
    torch.cuda.empty_cache()
    return {"paged": scan["paged"] + par["paged"], "flash": par["flash"]}


def _close(torch, what, got, want, tol=1e-4) -> float:
    err = (got - want).abs().max().item()
    try:
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    except AssertionError as exc:
        fail(f"slice parity {what}: cuda vs torch:\n{exc}")
    return err


def _parity_fp32(torch, cfg, g, tag: str):
    """fp32, ``cfg`` at full width: the ``"cuda"`` and ``"torch"`` arms of
    ``paged_decode_step`` over 6 steps, then the server's parallel prefill
    at the served bucket (the ``transformer.forward`` logits and the pages
    ``_parallel_prefill`` writes), within 1e-4. Returns the prompts."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import (ContinuousServer, PageAllocator,
                                     PagedCacheSpec, init_pages,
                                     paged_decode_step)
    dev = torch.device("cuda")
    params = T.init_params(g, cfg)
    spec = PagedCacheSpec.for_config(cfg, num_slots=8, page_size=16,
                                     max_seq=1024)
    alloc = PageAllocator(spec)
    for s in range(spec.num_slots):
        alloc.ensure(s, spec.seq_capacity)
    table = torch.tensor(alloc.tables, device=dev)
    base = init_pages(spec, dev)
    for x in base.values():                 # earlier context, already cached
        x.normal_(generator=g)
    pages = {impl: {k: v.clone() for k, v in base.items()}
             for impl in ("torch", "cuda")}
    start = torch.tensor([0, 15, 16, 100, 500, 900, 1000, 300],
                         dtype=torch.int32, device=dev)
    active = torch.tensor([True] * 7 + [False], device=dev)
    worst = 0.0
    for step in range(6):
        tok = torch.randint(cfg.vocab_size, (8, 1), generator=g, device=dev)
        logits = {impl: paged_decode_step(params, pages[impl], table, tok,
                                          start + step, active, cfg,
                                          attn_impl=impl)[0]
                  for impl in ("torch", "cuda")}
        worst = max(worst, _close(torch, f"decode step {step} logits",
                                  logits["cuda"], logits["torch"]))
    log(f"[{tag}] {cfg.name} widths, {cfg.num_layers} layers, fp32, 6 decode "
        f"steps: cuda vs torch logits max_abs_err={worst:.3e} (tol 1e-4) ok")
    del pages, base

    # the server's parallel prefill at the served bucket (Pb = 256): the
    # forward pass (flash kernel vs plain attention) and the page scatter
    plens = [256, 200, 17, 130, 64, 255, 1, 100]
    prompts = torch.randint(cfg.vocab_size, (8, 256), generator=g,
                            device=dev, dtype=torch.int32)
    fwd = {impl: T.forward(params, {"tokens": prompts}, cfg,
                           return_cache=True, attn_impl=impl)
           for impl in ("torch", "cuda")}
    e_logits = _close(torch, "prefill forward logits", fwd["cuda"][0],
                      fwd["torch"][0])
    del fwd
    written = {}
    for impl in ("torch", "cuda"):
        srv = ContinuousServer(cfg, params, slots=8, page_size=16,
                               max_seq=1024, attn_impl=impl,
                               prefill_mode="parallel", device=dev)
        for s, n in enumerate(plens):
            srv.alloc.ensure(s, n)
        srv._parallel_prefill(
            torch.tensor(srv.alloc.tables, device=dev), prompts,
            torch.tensor(plens, dtype=torch.int32, device=dev),
            torch.tensor([True] * 7 + [False], device=dev), gather_pages=None)
        written[impl] = srv.pages
        del srv
    e_pages = max(_close(torch, f"prefill pages {k}", written["cuda"][k],
                         written["torch"][k]) for k in ("k", "v"))
    log(f"[{tag}] {cfg.name} widths, {cfg.num_layers} layers, fp32, parallel "
        f"prefill of 8 prompts {plens} (bucket 256): cuda vs torch forward "
        f"logits max_abs_err={e_logits:.3e}, written pages max_abs_err="
        f"{e_pages:.3e} (tol 1e-4) ok")
    return prompts


def phase_parity(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2,
                              compute_dtype="float32")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    prompts = _parity_fp32(torch, cfg, g, "parity")

    # bf16, as serving runs it: the fp32 checks above reach only the
    # CUDA-core kernel; this one reaches the tensor-core kernel. Both bf16
    # arms are held to the fp32 forward of the same weights: the plain
    # arm rounds its attention scores to bf16 (the kernel keeps them in
    # fp32), so the two arms differ by about as much as either differs
    # from fp32, and the kernel arm must be no further from it.
    cfg16 = dataclasses.replace(get_config("qwen2-7b"), num_layers=2)
    params16 = T.init_params(g, cfg16, weight_dtype=torch.bfloat16)
    params32 = tree.tree_map(lambda t: t.float(), params16)
    truth = T.forward(params32, {"tokens": prompts}, cfg, attn_impl="torch")[0]
    del params32
    logits = {impl: T.forward(params16, {"tokens": prompts}, cfg16,
                              attn_impl=impl)[0].float()
              for impl in ("torch", "cuda")}

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    if not torch.isfinite(logits["cuda"]).all():
        fail("slice parity bf16 forward logits: not finite")
    err = {impl: rel(x, truth) for impl, x in logits.items()}
    cross = rel(logits["cuda"], logits["torch"])
    if err["cuda"] > err["torch"] or err["cuda"] > 2 * BF16_REL_RMS:
        fail(f"slice parity bf16 forward logits: relative RMS error against "
             f"fp32 {err['cuda']:.3e} (cuda) vs {err['torch']:.3e} (torch); "
             f"the cuda arm must be no further and within {2 * BF16_REL_RMS}")
    log(f"[parity] qwen2-7b widths, 2 layers, bf16, forward of 8 x 256 "
        f"tokens: logits rel_rms against the fp32 forward cuda="
        f"{err['cuda']:.3e} torch={err['torch']:.3e} (cuda must be <= torch "
        f"and <= {2 * BF16_REL_RMS}); cuda vs torch rel_rms={cross:.3e} ok")


# ---------------------------------------------------------------------------
# the CNN-training slice
# ---------------------------------------------------------------------------

def caffenet_layers():
    """[(x_shape, w_shape, stride), ...] of full-width CaffeNet's five conv
    layers at the group batch the training run gives each of them."""
    from repro_torch.models import cnn as C
    return C.conv_layer_shapes(C.CAFFENET, CNN_GROUP_BATCH)


def _check_wgrad(torch, tag, low, dy, ws) -> float:
    """wgrad against its plain version, and the same bits on a second call
    (the split over M is summed in a fixed order)."""
    from repro_torch.kernels.lowering_conv import bwd
    got = bwd.wgrad_cuda(low, dy, ws)
    err = compare_fp32(torch, f"wgrad {tag}", got, bwd.wgrad_ref(low, dy, ws))
    rows, slices = bwd.wgrad_slices(dy.numel() // ws[3], low.shape[-1],
                                    ws[3])
    if not torch.equal(bwd.wgrad_cuda(low, dy, ws), got):
        fail(f"wgrad {tag}: a second call gave other bits")
    log(f"[check] wgrad {tag}: {slices} slices of {rows} rows, the same bits "
        "on a second call ok")
    return err


def _check_conv_layers(torch, g, layers, label: str, errs: dict,
                       dgrad_first: bool = False) -> None:
    """B2 (its lowered residual bitwise), B3 and B4 against their plain
    versions at each ``(x_shape, w_shape, stride)`` of ``layers``; the
    largest errors land in ``errs``. Layer 0 takes no dgrad on the model's
    path (``needs_dgrad=False``) unless ``dgrad_first``."""
    from repro_torch.kernels.lowering_conv import bwd
    from repro_torch.kernels.lowering_conv.lowering_conv import \
        lowering_conv_cuda
    from repro_torch.kernels.lowering_conv.ref import lower
    dev = torch.device("cuda")
    for i, (xs, ws, s) in enumerate(layers):
        x = torch.randn(xs, generator=g, device=dev)
        w = torch.randn(ws, generator=g, device=dev) * 0.05
        kh, kw, cin, cout = ws
        tag = f"{label}conv{i + 1} x{xs} w{ws} s{s}"
        y, low = lowering_conv_cuda(x, w, stride=s, return_lowered=True)
        low_ref = lower(x, kh, kw, s)
        y_ref = (low_ref @ w.reshape(kh * kw * cin, cout)).reshape(y.shape)
        errs["lowering_conv"] = max(errs["lowering_conv"], compare_fp32(
            torch, f"lowering_conv {tag}", y, y_ref))
        if not torch.equal(low.reshape(low_ref.shape), low_ref):
            fail(f"lowering_conv {tag}: the lowered residual differs from "
                 "ref.lower (must be bitwise equal)")
        log(f"[check] lowering_conv {tag}: residual {tuple(low.shape)} "
            "bitwise equal to ref.lower ok")
        dy = torch.randn(y.shape, generator=g, device=dev)
        del y, y_ref, low_ref
        errs["wgrad"] = max(errs["wgrad"], _check_wgrad(torch, tag, low, dy,
                                                        ws))
        if i > 0 or dgrad_first:      # conv1 has needs_dgrad=False
            errs["dgrad"] = max(errs["dgrad"], compare_fp32(
                torch, f"dgrad {tag}", bwd.dgrad_cuda(dy, w, xs, stride=s),
                bwd.dgrad_ref(dy, w, xs, s)))
        del x, w, low, dy
    torch.cuda.empty_cache()


def phase_check_train(torch) -> dict:
    from repro_torch.core import tree as T
    from repro_torch.kernels.fused_update import ops as fu
    from repro_torch.kernels.fused_update.ref import fused_update_ref
    from repro_torch.kernels.lowering_conv import bwd
    from repro_torch.kernels.lowering_conv.lowering_conv import \
        lowering_conv_cuda
    from repro_torch.kernels.lowering_conv.ref import lower
    from repro_torch.models import cnn as C
    from repro_torch.optim.closed_form import grouped_coeffs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    errs = dict.fromkeys(("fused_update", "lowering_conv", "wgrad", "dgrad"),
                         0.0)

    # B1: bitwise, CaffeNet's largest leaf and the slab of all 16 leaves
    params = C.init_params(g, C.CAFFENET)
    leaves = T.leaves(params)
    c = grouped_coeffs(CNN_GROUPS, lr=0.01, momentum=0.3)
    big = max(leaves, key=lambda p: p.numel())
    shape = "x".join(map(str, big.shape))
    cases = [(f"largest leaf {shape} fp32", big),
             (f"slab of all {len(leaves)} leaves fp32",
              torch.cat([p.reshape(-1) for p in leaves])),
             (f"largest leaf {shape} bf16", big.bfloat16())]
    for label, w in cases:
        v = (torch.randn(w.shape, generator=g, device=dev) * 1e-2).to(w.dtype)
        gs = (torch.randn((CNN_GROUPS,) + tuple(w.shape), generator=g,
                          device=dev) * 1e-3).to(w.dtype)
        got = fu.fused_update_cuda(w, v, gs, c)
        want = fused_update_ref(w, v, gs, c)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            bad = (got[0] != want[0]).sum().item() + (got[1] != want[1]).sum(
                ).item()
            fail(f"fused_update {label} g={CNN_GROUPS}: {bad} elements differ "
                 "from the plain version (must be bitwise equal)")
        log(f"[check] fused_update {label} ({w.numel()} elements) "
            f"g={CNN_GROUPS}: bitwise equal to the plain version ok")
        del v, gs, got, want
    del params, leaves, cases, big

    # B2-B4 at the five CaffeNet layers, then a stride-2 dgrad
    _check_conv_layers(torch, g, caffenet_layers(), "", errs)
    for label, xs, ws, s in (
            # ragged tiles: Cin 70 and 130 fill no tile, Cout 50 is no
            # multiple of 4 (4-byte copies), 36 no multiple of the stage
            ("ragged", (CNN_GROUP_BATCH, 13, 13, 70), (3, 3, 70, 50), 1),
            ("ragged", (CNN_GROUP_BATCH, 15, 15, 130), (3, 3, 130, 36), 1),
            ("stride 2", (CNN_GROUP_BATCH, 27, 27, 96), (5, 5, 96, 256), 2)):
        w = torch.randn(ws, generator=g, device=dev) * 0.05
        ho = (xs[1] - ws[0]) // s + 1
        dy = torch.randn((xs[0], ho, ho, ws[3]), generator=g, device=dev)
        errs["dgrad"] = max(errs["dgrad"], compare_fp32(
            torch, f"dgrad {label} x{xs} w{ws} s{s}",
            bwd.dgrad_cuda(dy, w, xs, stride=s), bwd.dgrad_ref(dy, w, xs, s)))
        del w, dy
    for label, xs, ws in (
            # the forward's ragged W boxes: Cout 50 and 36 fill no tile
            ("ragged", (CNN_GROUP_BATCH, 13, 13, 70), (3, 3, 70, 50)),
            ("ragged", (CNN_GROUP_BATCH, 15, 15, 130), (3, 3, 130, 36))):
        x = torch.randn(xs, generator=g, device=dev)
        w = torch.randn(ws, generator=g, device=dev) * 0.05
        y, low = lowering_conv_cuda(x, w, return_lowered=True)
        low_ref = lower(x, ws[0], ws[1], 1)
        errs["lowering_conv"] = max(errs["lowering_conv"], compare_fp32(
            torch, f"lowering_conv {label} x{xs} w{ws}", y,
            (low_ref @ w.reshape(-1, ws[3])).reshape(y.shape)))
        if not torch.equal(low.reshape(low_ref.shape), low_ref):
            fail(f"lowering_conv {label} x{xs} w{ws}: the lowered residual "
                 "differs from ref.lower (must be bitwise equal)")
        del x, w, y, low, low_ref
    for label, m, ws in (
            # the dgrad loop's ragged tiles (Cout 50: 4-byte copies of dY
            # and of the 630-float residual rows), then M off the 32-row
            # stage and M below one stage
            ("ragged", CNN_GROUP_BATCH * 11 * 11, (3, 3, 70, 50)),
            ("ragged", CNN_GROUP_BATCH * 13 * 13, (3, 3, 130, 36)),
            ("M off the stage", 3 * 11 * 11, (3, 3, 96, 64)),
            ("M < 32", 25, (3, 3, 96, 96))):
        low = torch.randn((m, ws[0] * ws[1] * ws[2]), generator=g, device=dev)
        dy = torch.randn((m, ws[3]), generator=g, device=dev)
        errs["wgrad"] = max(errs["wgrad"], _check_wgrad(
            torch, f"{label} M={m} w{ws}", low, dy, ws))
        del low, dy
    torch.cuda.empty_cache()
    return errs


def phase_time_train(torch) -> dict:
    """Device times at the training path's shapes: the fused update over
    the 16 CaffeNet leaves of one round (g = 4), the conv kernels summed
    over the five layers of one group's calls (group batch 64; dgrad over
    layers 2-5), each beside its plain version, one PyTorch library call
    and its bound (HBM, and the product form's 2*M*K*Cout flops at the
    kernel's rate: three TF32 tensor-core products a flop for the 3xTF32
    of B2, B3 and B4, with the fp32 CUDA-core bound printed beside it)."""
    import torch.nn.functional as F
    from repro_torch.core import tree as T
    from repro_torch.kernels.fused_update import ops as fu
    from repro_torch.kernels.fused_update.ref import fused_update_ref
    from repro_torch.kernels.lowering_conv import bwd
    from repro_torch.kernels.lowering_conv.lowering_conv import \
        lowering_conv_cuda
    from repro_torch.kernels.lowering_conv.ref import lower
    from repro_torch.models import cnn as C
    from repro_torch.optim.closed_form import grouped_coeffs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {}

    # B1: one round's 16 leaf updates, g = 4
    gsz = CNN_GROUPS
    leaves = T.leaves(C.init_params(g, C.CAFFENET))
    vs = [torch.randn_like(p) * 1e-2 for p in leaves]
    gss = [torch.randn((gsz,) + tuple(p.shape), generator=g, device=dev)
           for p in leaves]
    c = grouped_coeffs(gsz, lr=0.01, momentum=0.3)
    n = sum(p.numel() for p in leaves)

    def run_all(fn):
        return lambda: [fn(p, v, gg, c) for p, v, gg in zip(leaves, vs, gss)]

    ms = cuda_ms(torch, run_all(fu.fused_update_cuda), iters=20, flush=flush)
    plain = cuda_ms(torch, run_all(fused_update_ref), iters=10, flush=flush)
    b_ms, b_by = bound(4 * (gsz + 4) * n, (4 * gsz + 6) * n, FP32_FLOP_S)
    out["fused_update"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                               bound_ms=b_ms, bound_by=b_by)
    log(f"[time] fused_update fp32 g={gsz}, the {len(leaves)} CaffeNet "
        f"leaves of one round ({n} params, {len(leaves)} launches): "
        f"kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms=none (no single "
        f"PyTorch call computes it) bound_ms={b_ms:.5f} ({b_by}) "
        f"achieved={4 * (gsz + 4) * n / ms / 1e6:.0f} GB/s")
    del leaves, vs, gss

    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0,
                   flops=0.0) for k in ("lowering_conv", "wgrad", "dgrad")}

    def bounds(nbytes, flops):
        """3xTF32: three TF32 tensor-core products a necessary flop."""
        b_ms, b_by = bound(nbytes, flops, TF32_FLOP_S / 3)
        return b_ms, b_by, (
            f"bound_ms={b_ms:.5f} ({b_by}) [3xTF32 at "
            f"{TF32_FLOP_S / 1e12:.0f} TFLOP/s; fp32 CUDA cores: "
            f"{bound(nbytes, flops, FP32_FLOP_S)[0]:.5f}]")

    def add(name, tag, ms, plain, lib, nbytes, flops):
        t = tot[name]
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("nbytes", nbytes), ("flops", flops)):
            t[k] += v
        log(f"[time] {name} {tag}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} {bounds(nbytes, flops)[2]} "
            f"achieved={flops / ms / 1e9:.2f} TFLOP/s")

    for i, (xs, ws, s) in enumerate(caffenet_layers()):
        x = torch.randn(xs, generator=g, device=dev)
        w = torch.randn(ws, generator=g, device=dev) * 0.05
        kh, kw, cin, cout = ws
        K = kh * kw * cin
        y, low = lowering_conv_cuda(x, w, stride=s, return_lowered=True)
        M = y.numel() // cout
        dy = torch.randn(y.shape, generator=g, device=dev)
        xc = x.permute(0, 3, 1, 2)                   # NCHW view, channels-last
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        dyc = dy.permute(0, 3, 1, 2)
        wm = w.reshape(K, cout)
        tag = f"conv{i + 1} x{xs} w{ws} s{s}"
        gemm = 2.0 * M * K * cout
        add("lowering_conv", tag + " (with the residual)",
            cuda_ms(torch, lambda: lowering_conv_cuda(
                x, w, stride=s, return_lowered=True), iters=10, flush=flush),
            cuda_ms(torch, lambda: lower(x, kh, kw, s) @ wm, iters=5,
                    flush=flush),
            cuda_ms(torch, lambda: F.conv2d(xc, wc, stride=s), iters=10,
                    flush=flush),
            4.0 * (x.numel() + w.numel() + M * cout + M * K), gemm)
        add("wgrad", tag,
            cuda_ms(torch, lambda: bwd.wgrad_cuda(low, dy, ws), iters=10,
                    flush=flush),
            cuda_ms(torch, lambda: bwd.wgrad_ref(low, dy, ws), iters=5,
                    flush=flush),
            cuda_ms(torch, lambda: torch.nn.grad.conv2d_weight(
                xc, wc.shape, dyc, stride=s), iters=10, flush=flush),
            4.0 * (M * K + M * cout + K * cout), gemm)
        if i > 0:
            add("dgrad", tag,
                cuda_ms(torch, lambda: bwd.dgrad_cuda(dy, w, xs, stride=s),
                        iters=10, flush=flush),
                cuda_ms(torch, lambda: bwd.dgrad_ref(dy, w, xs, s), iters=5,
                        flush=flush),
                cuda_ms(torch, lambda: torch.nn.grad.conv2d_input(
                    xc.shape, wc, dyc, stride=s), iters=10, flush=flush),
                4.0 * (M * cout + K * cout + x.numel()), gemm)
        del x, w, y, low, dy, xc, wc, dyc, wm
    for name, t in tot.items():
        b_ms, b_by, text = bounds(t["nbytes"], t["flops"])
        out[name] = dict(ms=t["ms"], plain_ms=t["plain_ms"],
                         library_ms=t["library_ms"], bound_ms=b_ms,
                         bound_by=b_by)
        log(f"[time] {name} summed over one group's layers: "
            f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms']:.4f} {text} "
            f"achieved={t['flops'] / t['ms'] / 1e9:.2f} TFLOP/s")
    del flush
    torch.cuda.empty_cache()
    return out


def _train_counts():
    from repro_torch.kernels.fused_update import ops as fu
    from repro_torch.kernels.lowering_conv import bwd
    from repro_torch.kernels.lowering_conv import lowering_conv as lc
    return {"lowering_conv": lc.lowering_conv_cuda,
            "wgrad": bwd.wgrad_cuda, "dgrad": bwd.dgrad_cuda,
            "fused_update": fu.fused_update_cuda}


def _counted(torch, fn):
    """``fn()`` with the four training kernels' counts zeroed just before
    it and read just after: -> (its result, the counts)."""
    counts = _train_counts()
    for k in counts.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in counts.items()}


def _want_rounds(g: int, rounds: int) -> dict:
    """A CaffeNet round's launches: lowering_conv and wgrad 5 a group,
    dgrad 4 a group (conv1 takes none), B1 once a leaf (16)."""
    return {"lowering_conv": 5 * g * rounds, "wgrad": 5 * g * rounds,
            "dgrad": 4 * g * rounds, "fused_update": 16 * rounds}


def _train_run(torch, engine, params, mom, data, rounds: int, label: str):
    """One engine run with the four launch counts zeroed just before it and
    checked just after against the run's own rounds."""
    g = engine.num_groups
    (params, mom, losses), got = _counted(torch, lambda: engine.run(
        params, mom, data.batches(rounds), steps=rounds, log_every=1,
        log=lambda m: log(f"[train:{label}] {m}")))
    want = _want_rounds(g, rounds)
    log(f"[train:{label}] {rounds} rounds at g={g}: launches {got} "
        f"(want {want})")
    if len(losses) != rounds:
        fail(f"{label} run: {len(losses)} of {rounds} rounds ran")
    if got != want:
        fail(f"{label} run: launch counts {got} != {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label} run: non-finite loss in {losses}")
    tel = engine.telemetry
    steady = tel.step_s[tel.skip:]
    log(f"[train:{label}] losses {[round(x, 4) for x in losses]}; step ms "
        f"(host clock, after the warm-up round) median "
        f"{statistics.median(steady) * 1e3:.1f} min {min(steady) * 1e3:.1f} "
        f"max {max(steady) * 1e3:.1f}; images/s "
        f"{CNN_BATCH / statistics.median(steady):.1f}; first round "
        f"{tel.step_s[0] * 1e3:.1f} ms; host data wait median "
        f"{statistics.median(tel.data_s[tel.skip:]) * 1e3:.1f} ms")
    return params, mom, got


def phase_train_profile(torch, engine, params, mom, batch, what: str,
                        names) -> None:
    """One round: wall on the host clock (no profiler), device busy time
    (the sum of kernel times under ``torch.profiler``), the device's idle
    share, and the kernels that take the time (the port's ``names``
    whether or not they are among them)."""
    _profile_fn(torch, lambda: engine.step(params, mom, batch),
                f"{what}, g={engine.num_groups}", names, reps=1)


def phase_train(torch):
    """-> (launch counts, the g = 4 run's images/s inside the step)."""
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import DataConfig, SyntheticImages, prefetch
    from repro_torch.engine import Engine
    from repro_torch.models import cnn as C
    from repro_torch.optim.sgd import init_momentum
    cfg = C.CAFFENET
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    params = C.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in T.leaves(params))
    t0 = time.perf_counter()
    data = SyntheticImages(DataConfig(
        batch_size=CNN_BATCH, image_size=cfg.image_size,
        channels=cfg.in_channels, num_classes=cfg.num_classes, seed=0))
    log(f"[train] CaffeNet {cfg.image_size}x{cfg.image_size}x"
        f"{cfg.in_channels}, {cfg.num_classes} classes, {n_params} fp32 "
        f"params ({len(T.leaves(params))} leaves), conv_impl="
        f"{cfg.conv_impl}; image stream set up in "
        f"{time.perf_counter() - t0:.1f} s")
    kw = dict(lr=0.01, momentum=0.3, head_filter=C.head_filter,
              update_impl="cuda", device=dev)

    def loss_fn(p, b):
        return C.loss_fn(p, b, cfg)

    eng = Engine(loss_fn, strategy="grouped-fused", num_groups=CNN_GROUPS,
                 **kw)
    log(f"[train] {eng.describe()} "
        f"batch {CNN_BATCH}")
    params, mom, c4 = _train_run(torch, eng, params, init_momentum(params),
                                 data, 6, "g4")
    tel = eng.telemetry
    run_ips = CNN_BATCH / statistics.median(tel.step_s[tel.skip:])
    batch = next(prefetch(data.batches(1), device=dev))
    phase_train_profile(torch, eng, params, mom, batch,
                        f"full-width CaffeNet round, batch {CNN_BATCH}",
                        ("lowering_conv_kernel", "split_transpose",
                         "slice_sum", "wgrad", "dgrad", "fused_update"))
    sync = Engine(loss_fn, strategy="sync", num_groups=1, **kw)
    params, mom, c1 = _train_run(torch, sync, params, mom, data, 3, "sync")
    log(f"[train] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        "GB")
    del params, mom, batch
    torch.cuda.empty_cache()
    return {k: c4[k] + c1[k] for k in c4}, run_ips


def phase_train_parity(torch) -> None:
    """Full CaffeNet widths, batch 8, g = 2: one round through the kernel
    arms and one through the plain arms, from the same parameters."""
    import dataclasses
    from repro_torch.core import tree as T
    from repro_torch.engine import Engine
    from repro_torch.models import cnn as C
    from repro_torch.optim.sgd import init_momentum
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    params = C.init_params(g, C.CAFFENET)
    mom = T.tree_map(lambda p: torch.randn(p.shape, generator=g,
                                           device=dev) * 1e-3, params)
    cfg0 = C.CAFFENET
    size = (8, cfg0.image_size, cfg0.image_size, cfg0.in_channels)
    batch = {"images": torch.randn(size, generator=g, device=dev),
             "labels": torch.randint(cfg0.num_classes, (8,), generator=g,
                                     device=dev, dtype=torch.int32)}
    out = {}
    for conv, upd in (("lowering_cuda", "cuda"), ("lowering", "torch")):
        cfg = dataclasses.replace(cfg0, conv_impl=conv)
        eng = Engine(lambda p, b, cfg=cfg: C.loss_fn(p, b, cfg),
                     num_groups=2, lr=0.01, momentum=0.3, update_impl=upd,
                     head_filter=C.head_filter, device=dev)
        out[conv] = eng.step(params, mom, batch)
    (pk, vk, lk), (pp, vp, lp) = out["lowering_cuda"], out["lowering"]
    worst = _close(torch, "CaffeNet round loss", lk, lp)
    for (path, a), b in zip(T.leaves_with_path(pk) + T.leaves_with_path(vk),
                            T.leaves(pp) + T.leaves(vp)):
        worst = max(worst, _close(torch, f"CaffeNet round leaf {path}", a, b))
    log(f"[parity] full-width CaffeNet, batch 8, g=2, one round: kernel arms "
        f"vs plain arms, loss {lk.item():.6f} vs {lp.item():.6f}, max abs "
        f"err over the loss and the {len(T.leaves(pk))} updated leaves (and "
        f"their momentum) {worst:.3e} (tol 1e-4) ok")


# ---------------------------------------------------------------------------
# the multi-device engine
# ---------------------------------------------------------------------------

SPMD_ROUNDS = 2
#: (g, k, mp) of the four-rank gloo runs sharing the card
SPMD_MESHES = ((4, 1, 1), (2, 2, 1), (2, 1, 2))
SPMD_WORLD = 4


def _spmd_pair(torch, loss_fn, head_filter, params, host, *, g, mp,
               strategy, num_devices, device, update_impl,
               lr: float = 0.01) -> dict:
    """``Engine(exec_mode="spmd")`` over ``host`` (global batches), its
    launch counts zeroed just before and read just after, then
    ``exec_mode="reference"`` over the same rounds and (g, k); whether
    params, momentum, losses and per-shard losses are the same bits."""
    from repro_torch.core import tree as T
    from repro_torch.engine import Engine
    from repro_torch.optim.sgd import init_momentum
    kw = dict(strategy=strategy, num_groups=g, lr=lr, momentum=0.3,
              weight_decay=5e-4, head_filter=head_filter,
              update_impl=update_impl, mp=mp, device=device)
    mom = init_momentum(params)
    counts = _train_counts()
    eng = Engine(loss_fn, exec_mode="spmd", **kw)
    for fn in counts.values():
        fn.launches = 0
    p, v, losses = eng.run(params, mom, iter(host), steps=len(host))
    if device.type == "cuda":
        torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in counts.items()}
    built = eng._built_step(T.leaves(host[0])[0].shape[0] // g)
    ref = Engine(loss_fn, exec_mode="reference", num_devices=num_devices,
                 **kw)
    rp, rv, rlosses = ref.run(params, mom, iter(host), steps=len(host))
    bad = [str(path) for (path, a), b in zip(
        T.leaves_with_path(p) + T.leaves_with_path(v),
        T.leaves(rp) + T.leaves(rv)) if not torch.equal(a, b)]
    if losses != rlosses:
        bad.append(f"losses {losses} != {rlosses}")
    if len(eng.shard_losses) != len(ref.shard_losses) or not all(
            (a == b).all() for a, b in zip(eng.shard_losses,
                                           ref.shard_losses)):
        bad.append("per-shard losses")
    return {"mesh": list(built.fn.mesh_shape), "coord": list(built.coord),
            "counts": got, "bad": bad, "losses": losses,
            "shard_losses": [x.tolist() for x in eng.shard_losses],
            "buckets": [[b.nbytes, b.is_head, len(b.indices)]
                        for b in built.fn.buckets],
            "round_ms": [x * 1e3 for x in eng.telemetry.step_s]}


def _check_spmd(res: dict, label: str, rounds: int) -> None:
    """Bitwise the reference, finite losses, per-round launch counts."""
    if res["bad"]:
        fail(f"{label}: SPMD differs from the reference at {res['bad'][:5]}")
    if not all(math.isfinite(x) for x in res["losses"]):
        fail(f"{label}: non-finite loss in {res['losses']}")
    want = {"lowering_conv": 5 * rounds, "wgrad": 5 * rounds,
            "dgrad": 4 * rounds, "fused_update": len(res["buckets"]) * rounds}
    if res["counts"] != want:
        fail(f"{label}: launch counts {res['counts']} != {want}")


def _host_batches(cfg, rounds: int):
    from repro_torch.data.pipeline import DataConfig, SyntheticImages
    return list(SyntheticImages(DataConfig(
        batch_size=CNN_BATCH, image_size=cfg.image_size,
        channels=cfg.in_channels, num_classes=cfg.num_classes,
        seed=0)).batches(rounds))


def phase_spmd_nccl(torch) -> dict:
    """(a) World size 1 over NCCL: ``Engine(exec_mode="spmd")`` trains
    full-width CaffeNet at batch 256, g = 1 ``sync``, bitwise the
    reference on the card."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.models import cnn as C
    dev = torch.device("cuda")
    cfg = C.CAFFENET
    params = C.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    host = _host_batches(cfg, SPMD_ROUNDS)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            res = _spmd_pair(torch, lambda p, b: C.loss_fn(p, b, cfg),
                             C.head_filter, params, host, g=1, mp=1,
                             strategy="sync", num_devices=1, device=dev,
                             update_impl="cuda")
        finally:
            dist.destroy_process_group()
    _check_spmd(res, "spmd nccl world 1", SPMD_ROUNDS)
    log(f"[spmd] (a) NCCL, world size 1, mesh {tuple(res['mesh'])}, sync, "
        f"full-width CaffeNet batch {CNN_BATCH}, {SPMD_ROUNDS} rounds: "
        f"params, momentum, losses {res['losses']} and per-shard losses "
        f"bitwise the reference; launches {res['counts']} "
        f"({len(res['buckets'])} buckets a round)")
    return res["counts"]


def _spmd_rank(rank: int, world: int, tmp: str, meshes, backend: str):
    """One rank: every (g, k, mp) of ``meshes`` through ``_spmd_pair``,
    results to ``tmp/rank<r>.json``. Over gloo every rank shares card 0;
    over NCCL rank r takes card r."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.models import cnn as C
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=world)
    try:
        params = C.init_params(torch.Generator(device=dev).manual_seed(0),
                               C.CAFFENET)
        host = _host_batches(C.CAFFENET, SPMD_ROUNDS)
        out = {}
        for g, k, mp in meshes:
            res = _spmd_pair(torch,
                             lambda p, b: C.loss_fn(p, b, C.CAFFENET),
                             C.head_filter, params, host, g=g, mp=mp,
                             strategy="grouped-fused", num_devices=world,
                             device=dev, update_impl="cuda")
            if tuple(res["mesh"]) != (g, k, mp):
                raise RuntimeError(f"mesh {res['mesh']} for {(g, k, mp)}")
            out[f"{g}x{k}x{mp}"] = res
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def phase_spmd_ranks(torch, backend: str = "gloo") -> dict:
    """(b) Four ranks with CUDA tensors, full CaffeNet width, batch 256, at
    each of ``SPMD_MESHES``: every rank's params, momentum and per-shard
    losses bitwise the single-process reference of the same (g, k); the
    per-round launch counts of each rank; (c) the exchange's bucket layout
    and the round times. ``backend="gloo"`` (the default run): the ranks
    share the one card and gloo stages through the host, so the times are
    a correctness run's, not a speed figure; ``"nccl"``
    (``--spmd-nccl``): one rank per card, four cards."""
    import tempfile
    import torch.multiprocessing as mp
    if backend == "nccl" and torch.cuda.device_count() < SPMD_WORLD:
        fail(f"--spmd-nccl needs {SPMD_WORLD} cards, this machine has "
             f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_spmd_rank, args=(SPMD_WORLD, d, SPMD_MESHES, backend),
                 nprocs=SPMD_WORLD, join=True)
        ranks = []
        for r in range(SPMD_WORLD):
            with open(f"{d}/rank{r}.json") as f:
                ranks.append(json.load(f))
    total = {}
    for name in ranks[0]:
        for r, res in enumerate(ranks):
            label = f"spmd {backend} {name} rank {r}"
            _check_spmd(res[name], label, SPMD_ROUNDS)
            for kname, n in res[name]["counts"].items():
                total[kname] = total.get(kname, 0) + n
            if res[name]["shard_losses"] != ranks[0][name]["shard_losses"]:
                fail(f"{label}: per-shard losses differ from rank 0's")
        res = ranks[0][name]
        layout = res["buckets"]
        where = "on one card" if backend == "gloo" else "one a card"
        log(f"[spmd] (b) {backend}, {SPMD_WORLD} ranks {where}, mesh {name} "
            f"(g x k x mp), grouped-fused, {SPMD_ROUNDS} rounds: every "
            f"rank bitwise the reference; per-shard losses "
            f"{res['shard_losses']}; rank 0 launches {res['counts']}")
        log(f"[spmd] (c) {name} buckets: {len(layout)} a round (rank 0's "
            f"slabs), bytes {[b[0] for b in layout]}, head "
            f"{[int(b[1]) for b in layout]}, leaves {[b[2] for b in layout]}")
        what = ("gloo stages through the host: a correctness run, not a "
                "speed figure" if backend == "gloo" else
                "NCCL, single unprofiled rounds, unverified as speed "
                "figures")
        log(f"[spmd] (c) {name} round ms per rank (host clock, {what}): "
            + "; ".join(f"rank {r} " + ", ".join(
                f"{x:.1f}" for x in rk[name]["round_ms"])
                for r, rk in enumerate(ranks)))
    log(f"[spmd] (c) torch.cuda.device_count() = "
        f"{torch.cuda.device_count()}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return total


def phase_time_buckets(torch) -> None:
    """B1 once per bucket slab of the g = 4 exchange's layout (full-width
    CaffeNet, default target): bitwise its plain version on each slab, and
    its device time against its bytes bound."""
    from repro_torch.core import tree as T
    from repro_torch.core.async_sgd import head_mask_tree
    from repro_torch.engine.buckets import assign_buckets, pack_bucket
    from repro_torch.engine.spmd import DEFAULT_BUCKET_BYTES
    from repro_torch.kernels.fused_update import ops as fu
    from repro_torch.kernels.fused_update.ref import fused_update_ref
    from repro_torch.models import cnn as C
    from repro_torch.optim.closed_form import grouped_coeffs, head_coeffs
    dev = torch.device("cuda")
    g = 4
    gen = torch.Generator(device=dev).manual_seed(5)
    params = C.init_params(gen, C.CAFFENET)
    leaves = T.leaves(params)
    mask = T.leaves(head_mask_tree(params, C.head_filter))
    coeffs = grouped_coeffs(g, lr=0.01, momentum=0.3, weight_decay=5e-4)
    hcoeffs = head_coeffs(g, lr=0.01, momentum=0.3, weight_decay=5e-4)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    total_ms = total_bound = 0.0
    rows = []
    for b in assign_buckets(leaves, mask, DEFAULT_BUCKET_BYTES):
        w = pack_bucket(b, leaves)
        v = torch.randn(w.shape, generator=gen, device=dev) * 1e-3
        gs = torch.randn((g,) + tuple(w.shape), generator=gen, device=dev)
        c = hcoeffs if b.is_head else coeffs
        # the slab shapes the SPMD path gives B1, held to the plain version
        got, want = fu.fused_update_cuda(w, v, gs, c), fused_update_ref(
            w, v, gs, c)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"fused_update on the {b.nbytes} B slab: not bitwise equal "
                 "to its plain version")
        ms = cuda_ms(torch, lambda: fu.fused_update_cuda(w, v, gs, c),
                     iters=10, flush=flush)
        n = b.num_elements       # read w, v and g gradients; write w, v
        b_ms, b_by = bound(4 * (g + 4) * n, (4 * g + 6) * n, FP32_FLOP_S)
        total_ms += ms
        total_bound += b_ms
        rows.append(f"{b.nbytes} B{' head' if b.is_head else ''} "
                    f"{ms:.4f}/{b_ms:.4f} ({b_by})")
    log(f"[spmd] (c) B1 per bucket slab of the default layout, g={g}, "
        f"kernel ms / bound ms (CUDA events, L2 flushed): " + "; ".join(rows))
    log(f"[spmd] (c) B1 on each of the {len(rows)} slabs: bitwise equal "
        "to the plain version ok")
    log(f"[spmd] (c) B1 over the {len(rows)} slabs: {total_ms:.4f} ms, "
        f"bound {total_bound:.4f} ms ({total_bound / total_ms:.0%} of it)")
    del params, leaves, flush
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# LM training: qwen2-7b at full width, 2 of its 28 layers
# ---------------------------------------------------------------------------

LM_LAYERS = 2                  # the depth cut, the run's ``reduced`` list
LM_GROUPS, LM_BATCH, LM_SEQ = 4, 16, 512   # 4 sequences a group a round
LM_ROUNDS = 3                  # after one warm-up round
LM_LR, LM_MU = 0.05, 0.3       # the JAX launcher's own LM example
LM_SPMD_BATCH, LM_SPMD_ROUNDS = 4, 2
LM_LONG_SEQ, LM_LONG_BATCH = 4096, 2       # chunked attention under autograd


def lm_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2-7b"), num_layers=LM_LAYERS)


def _lm_stream(cfg, batch: int, seq: int):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(batch_size=batch, seq_len=seq,
                                  vocab_size=cfg.vocab_size, seed=0))


def _free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def lm_host_params(torch, cfg, tag: str = "lm"):
    """fp32 params from seed 0 (drawn on the card, where it takes
    milliseconds) and zero momentum, both on the host: the engine's copy is
    then the only one on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.models import transformer as M
    t0 = time.perf_counter()
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    params = M.init_params(gen, cfg)
    host = T.tree_map(lambda t: t.cpu(), params)
    del params
    _free(torch)
    mom = T.tree_map(torch.zeros_like, host)
    n = sum(t.numel() for t in T.leaves(host))
    log(f"[{tag}] {cfg.name} d_model {cfg.d_model} heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim {cfg.resolved_head_dim} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size}, {cfg.num_layers} layers "
        f"(reduced: num_layers {get_config(cfg.name).num_layers} -> "
        f"{cfg.num_layers}), compute "
        f"{cfg.compute_dtype}, remat {cfg.remat}: {n} fp32 params in "
        f"{len(T.leaves(host))} leaves ({4 * n / 1e9:.2f} GB), params and "
        f"momentum on the host in {time.perf_counter() - t0:.1f} s")
    return host, mom, n


def _all_counts():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    return {**_train_counts(), "flash": fa.flash_attention,
            "paged": pa.paged_attention}


def phase_lm_train(torch, cfg, host, mom, n_params, *,
                   rounds: int = LM_ROUNDS, tag: str = "lm:a",
                   profile: bool = True) -> dict:
    """(a) ``Engine`` trains the LM at g = 4 ``grouped-fused`` through B1:
    one warm-up round and ``rounds``, launch counts zeroed before the run
    and checked after it (B1 once a leaf a round, nothing else), then one
    profiled round (if ``profile``). Returns the run's launches, the
    params and momentum it ends on, and a round's batch."""
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import prefetch
    from repro_torch.engine import Engine
    from repro_torch.models import transformer as M
    dev = torch.device("cuda")
    g, rounds = LM_GROUPS, 1 + rounds
    eng = Engine(lambda p, b: M.lm_loss(p, b, cfg), strategy="grouped-fused",
                 num_groups=g, lr=LM_LR, momentum=LM_MU, update_impl="cuda",
                 device=dev)
    log(f"[{tag}] {eng.describe(LM_BATCH // g)} batch {LM_BATCH} x seq "
        f"{LM_SEQ} ({LM_BATCH * LM_SEQ} tokens a round)")
    data = _lm_stream(cfg, LM_BATCH, LM_SEQ)
    counts = _all_counts()
    torch.cuda.reset_peak_memory_stats()
    for fn in counts.values():
        fn.launches = 0
    params, mom, losses = eng.run(host, mom, data.batches(rounds),
                                  steps=rounds, log_every=1,
                                  log=lambda m: log(f"[{tag}] {m}"))
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in counts.items()}
    n_leaves = len(T.leaves(params))
    want = {k: 0 for k in got}
    want["fused_update"] = n_leaves * rounds
    log(f"[{tag}] {rounds} rounds: launches {got} (want {want})")
    if got != want:
        fail(f"LM g={g} run: launch counts {got} != {want}")
    if len(losses) != rounds or not all(math.isfinite(x) for x in losses):
        fail(f"LM g={g} run: losses {losses}")
    peak = PEAKS[tag] = torch.cuda.max_memory_allocated()
    tel = eng.telemetry
    steady = tel.step_s[tel.skip:]
    med = statistics.median(steady)
    tokens = LM_BATCH * LM_SEQ
    logits = (LM_BATCH // g) * LM_SEQ * cfg.vocab_size
    log(f"[{tag}] losses {[round(x, 4) for x in losses]}; round ms (host "
        f"clock, after the warm-up round) median {med * 1e3:.1f} min "
        f"{min(steady) * 1e3:.1f} max {max(steady) * 1e3:.1f}; tokens/s "
        f"{tokens / med:.1f}; first round {tel.step_s[0] * 1e3:.1f} ms; "
        f"host data wait median "
        f"{statistics.median(tel.data_s[tel.skip:]) * 1e3:.1f} ms")
    log(f"[{tag}] peak memory {peak / 1e9:.2f} GB; reckoned: (4 + g) x P x "
        f"4 B = {(4 + g) * n_params * 4 / 1e9:.2f} GB at the update (params "
        f"and momentum in and out, g gradient stacks) plus a group's fp32 "
        f"logits, log-softmax and their gradients ({logits} elements, "
        f"{4 * 4 * logits / 1e9:.2f} GB)")
    batch = next(prefetch(data.batches(1), device=dev))
    if profile:
        phase_train_profile(
            torch, eng, params, mom, batch,
            f"{cfg.name} {cfg.num_layers}-layer round, batch {LM_BATCH} x "
            f"seq {LM_SEQ}", ("fused_update",))
    return {"fused_update": got["fused_update"], "params": params,
            "mom": mom, "batch": batch}


def phase_lm_update(torch, cfg, params, mom, batch, tag: str = "lm:b"
                    ) -> None:
    """(b) B1 at the LM round's leaves: the round's own (g, ...) gradient
    stacks, the ``"cuda"`` and ``"torch"`` update arms bitwise equal on
    every leaf (params and momentum), and B1 over the leaves timed against
    its bytes bound."""
    from repro_torch.core import tree as T
    from repro_torch.core.async_sgd import stacked_group_grads, value_and_grad
    from repro_torch.core.compute_groups import group_batch_split
    from repro_torch.kernels.fused_update import ops as fu
    from repro_torch.models import transformer as M
    from repro_torch.optim.closed_form import grouped_coeffs
    g = LM_GROUPS
    _, stacks = stacked_group_grads(
        lambda p, b: value_and_grad(lambda q, c: M.lm_loss(q, c, cfg), p, b),
        params, group_batch_split(batch, g), g)
    coeffs = grouped_coeffs(g, lr=LM_LR, momentum=LM_MU)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device=torch.device("cuda"))
    total_ms = n = 0
    rows = []
    for (path, w), v, gs in zip(T.leaves_with_path(params), T.leaves(mom),
                                stacks):
        got = fu.fused_update(w, v, gs, coeffs=coeffs, impl="cuda")
        want = fu.fused_update(w, v, gs, coeffs=coeffs, impl="torch")
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"fused_update on LM leaf {path}: not bitwise equal to "
                 "its plain version")
        del got, want
        ms = cuda_ms(torch, lambda: fu.fused_update_cuda(w, v, gs, coeffs),
                     iters=5, flush=flush)
        total_ms += ms
        n += w.numel()
        rows.append(f"{'.'.join(map(str, path))} {tuple(w.shape)} "
                    f"{ms:.4f}")
    b_ms, b_by = bound(4 * (g + 4) * n, (4 * g + 6) * n, FP32_FLOP_S)
    log(f"[{tag}] B1 on each of the {len(rows)} leaves of the round's own "
        f"g={g} gradient stacks: cuda and torch arms bitwise equal (params "
        "and momentum) ok")
    log(f"[{tag}] B1 per leaf, kernel ms (CUDA events, L2 flushed): "
        + "; ".join(rows))
    log(f"[{tag}] B1 over the {len(rows)} leaves ({n} elements): "
        f"{total_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; (2 + g + 2) x "
        f"4 B x P / {HBM_BYTES_S / 1e12:.2f} TB/s), "
        f"{b_ms / total_ms:.0%} of it")
    del stacks, flush


def phase_lm_spmd(torch, cfg, host) -> dict:
    """(c) The SPMD engine over NCCL at world size 1: ``sync``, g = 1,
    bitwise its ``exec_mode="reference"`` twin on the LM; the bucket
    layout."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.models import transformer as M
    dev = torch.device("cuda")
    data = list(_lm_stream(cfg, LM_SPMD_BATCH, LM_SEQ).batches(
        LM_SPMD_ROUNDS))
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            res = _spmd_pair(torch, lambda p, b: M.lm_loss(p, b, cfg), None,
                             host, data, g=1, mp=1, strategy="sync",
                             num_devices=1, device=dev, update_impl="cuda",
                             lr=LM_LR)
        finally:
            dist.destroy_process_group()
    want = {k: 0 for k in res["counts"]}
    want["fused_update"] = len(res["buckets"]) * LM_SPMD_ROUNDS
    if res["bad"]:
        fail(f"LM spmd nccl world 1: differs from the reference at "
             f"{res['bad'][:5]}")
    if res["counts"] != want:
        fail(f"LM spmd nccl world 1: launch counts {res['counts']} != "
             f"{want}")
    if not all(math.isfinite(x) for x in res["losses"]):
        fail(f"LM spmd nccl world 1: losses {res['losses']}")
    layout = res["buckets"]
    log(f"[lm:c] NCCL, world size 1, mesh {tuple(res['mesh'])}, sync, "
        f"batch {LM_SPMD_BATCH} x seq {LM_SEQ}, {LM_SPMD_ROUNDS} rounds: "
        f"params, momentum, losses {res['losses']} and per-shard losses "
        f"bitwise the reference; launches {res['counts']}")
    log(f"[lm:c] buckets: {len(layout)} a round, bytes "
        f"{[b[0] for b in layout]}, leaves {[b[2] for b in layout]}; round "
        f"ms (host clock) {[round(x, 1) for x in res['round_ms']]}")
    return {"fused_update": res["counts"]["fused_update"]}


def phase_lm_steps(torch, cfg, host) -> dict:
    """(d) ``steps.make_train_step`` with ``grad_accum=2`` at seq 4096
    (``chunked_attention`` under autograd, remat on), then
    ``make_prefill_step`` through both attention arms against the fp32
    prefill, and ``make_decode_step`` from ``init_cache``."""
    from repro_torch.configs import InputShape, TrainConfig
    from repro_torch.core import tree as T
    from repro_torch.launch import steps as S
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as M
    from repro_torch.optim.sgd import init_momentum
    dev = torch.device("cuda")
    if LM_LONG_SEQ < L.CHUNKED_ATTN_THRESHOLD:
        fail("the long step must reach chunked_attention")
    params = T.tree_map(lambda t: t.to(dev), host)
    mom = init_momentum(params)
    tc = TrainConfig(learning_rate=LM_LR, momentum=LM_MU, weight_decay=5e-4,
                     grad_accum=2)
    step = S.make_train_step(cfg, tc, InputShape(
        "train", LM_LONG_SEQ, LM_LONG_BATCH, "train"))
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for b in _lm_stream(cfg, LM_LONG_BATCH, LM_LONG_SEQ).batches(2):
        micro = {k: torch.from_numpy(v).to(dev).reshape(
            tc.grad_accum, LM_LONG_BATCH // tc.grad_accum, -1)
            for k, v in b.items()}
        t0 = time.perf_counter()
        params, mom, loss = step(params, mom, micro)
        losses.append(float(loss))        # synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(x) for x in losses):
        fail(f"make_train_step at seq {LM_LONG_SEQ}: losses {losses}")
    log(f"[lm:d] make_train_step grad_accum=2, weight decay 5e-4, batch "
        f"{LM_LONG_BATCH} x seq {LM_LONG_SEQ} (chunked_attention under "
        f"autograd): losses {[round(x, 4) for x in losses]}, step ms (host "
        f"clock) {[round(x, 1) for x in times]}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del mom

    from repro_torch.kernels.flash_attention import ops as fa
    pshape = InputShape("prefill", LM_SEQ, LM_SPMD_BATCH, "prefill")
    toks = next(_lm_stream(cfg, LM_SPMD_BATCH, LM_SEQ).batches(1))["tokens"]
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    truth = S.make_prefill_step(dataclasses.replace(
        cfg, compute_dtype="float32"), pshape)(params, batch)[0].float()
    out = {"torch": S.make_prefill_step(cfg, pshape)(params, batch)}
    fa.flash_attention.launches = 0
    out["cuda"] = S.make_prefill_step(cfg, pshape, attn_impl="cuda")(
        params, batch)
    torch.cuda.synchronize()
    flash = fa.flash_attention.launches
    if flash != cfg.num_layers:
        fail(f"prefill step: {flash} flash launches, want {cfg.num_layers}")

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    err = {k: rel(v[0].float(), truth) for k, v in out.items()}
    if not torch.isfinite(out["cuda"][0]).all() or (
            err["cuda"] > err["torch"] or err["cuda"] > 2 * BF16_REL_RMS):
        fail(f"prefill step bf16 last-position logits: relative RMS error "
             f"against fp32 {err['cuda']:.3e} (cuda) vs {err['torch']:.3e} "
             f"(torch); the cuda arm must be no further and within "
             f"{2 * BF16_REL_RMS}")
    log(f"[lm:d] make_prefill_step batch {LM_SPMD_BATCH} x {LM_SEQ}: "
        f"last-position logits rel_rms against the fp32 prefill cuda="
        f"{err['cuda']:.3e} torch={err['torch']:.3e} (cuda must be <= torch "
        f"and <= {2 * BF16_REL_RMS}); {flash} flash launches ok")
    del out, truth
    decode = S.make_decode_step(cfg, InputShape("decode", LM_SEQ,
                                                LM_SPMD_BATCH, "decode"))
    cache = M.init_cache(cfg, LM_SPMD_BATCH, LM_SEQ, device=dev)
    tok = batch["tokens"][:, :1]
    seq = []
    for pos in range(4):
        tok, cache = decode(params, cache, {"tokens": tok}, pos)
        seq.append(tok)
    seq = torch.cat(seq, dim=1)
    if seq.dtype != torch.int32 or seq.shape != (LM_SPMD_BATCH, 4) or not (
            (seq >= 0) & (seq < cfg.vocab_size)).all():
        fail(f"decode step: tokens {seq}")
    log(f"[lm:d] make_decode_step from init_cache, 4 tokens: "
        f"{seq.tolist()} ok")
    return {"flash": flash}


def phase_lm(torch) -> dict:
    """LM training at full qwen2-7b width: (a) the engine's g = 4 round,
    (b) B1 at its leaves, (c) the SPMD engine over NCCL, (d) the steps."""
    cfg = lm_config()
    host, mom, n = lm_host_params(torch, cfg)
    a = phase_lm_train(torch, cfg, host, mom, n)
    phase_lm_update(torch, cfg, a["params"], a["mom"], a["batch"])
    launches = {"fused_update": a["fused_update"]}
    del a
    _free(torch)
    c = phase_lm_spmd(torch, cfg, host)
    launches["fused_update"] += c["fused_update"]
    _free(torch)
    launches.update(phase_lm_steps(torch, cfg, host))
    _free(torch)
    return launches


# ---------------------------------------------------------------------------
# the optimizer: the engine's black-box probe, a planned run, Algorithm 1
# ---------------------------------------------------------------------------

#: the paper's §VI-A EC2 nodes (g2 GPU, c4 CPU): at CaffeNet's batch 256 the
#: planner picks g = 4 at unequal shares (93, 93, 35, 35)
OPT_SPEC = "2xgpu-g2.2xlarge,2xcpu-c4.4xlarge"
OPT_ROUNDS = 5                 # the planned run, the first a warm-up
OPT_PROFILE_ITERS = 5          # Engine.profile's timed rounds, after one
PROFILE_AGREE = 1.5            # Engine.profile against Engine.run's images/s
#: Algorithm 1 over cnn_classify: a g = 4 start on 4 devices, one epoch
OPT_ALG1 = dict(n_devices=4, epochs=1, epoch_steps=20, probe_steps=10, g0=4)


def phase_opt_profile(torch, run_ips: float):
    """(a) ``Engine.profiled_spec`` of ``gpu-h100-sxm``: ``Engine.profile``
    of the g = 4 ``grouped-fused`` CaffeNet round at batch 256 (one
    warm-up and ``OPT_PROFILE_ITERS`` timed rounds, the card synchronized
    around each), held within ``PROFILE_AGREE`` of phase 8's ``Engine.run``
    reading. -> (the measured spec, the launch counts)."""
    from repro_torch import cluster
    from repro_torch.data.pipeline import DataConfig, SyntheticImages
    from repro_torch.engine import Engine
    from repro_torch.models import cnn as C
    from repro_torch.optim.sgd import init_momentum
    cfg = C.CAFFENET
    params = C.init_params(torch.Generator(device=torch.device(
        "cuda")).manual_seed(0), cfg)
    mom = init_momentum(params)
    batch = next(SyntheticImages(DataConfig(
        batch_size=CNN_BATCH, image_size=cfg.image_size,
        channels=cfg.in_channels, num_classes=cfg.num_classes,
        seed=0)).batches(1))
    eng = Engine(lambda p, b: C.loss_fn(p, b, cfg), strategy="grouped-fused",
                 num_groups=CNN_GROUPS, lr=0.01, momentum=0.3,
                 head_filter=C.head_filter, update_impl="cuda",
                 device=torch.device("cuda"))
    spec, got = _counted(torch, lambda: eng.profiled_spec(
        cluster.get_device("gpu-h100-sxm"), params, mom, batch, warmup=1,
        iters=OPT_PROFILE_ITERS))
    want = _want_rounds(CNN_GROUPS, 1 + OPT_PROFILE_ITERS)
    ratio = spec.throughput / run_ips
    log(f"[opt:profile] Engine.profile, CaffeNet g={CNN_GROUPS} "
        f"grouped-fused batch {CNN_BATCH}: {spec.throughput:.1f} images/s "
        f"({CNN_BATCH / spec.throughput * 1e3:.2f} ms a round, median of "
        f"{OPT_PROFILE_ITERS}); phase 8 Engine.run {run_ips:.1f} images/s; "
        f"ratio {ratio:.3f} (limit {PROFILE_AGREE}); launches {got} (want "
        f"{want})")
    if got != want:
        fail(f"Engine.profile: launch counts {got} != {want}")
    if not 1 / PROFILE_AGREE <= ratio <= PROFILE_AGREE:
        fail(f"Engine.profile reads {spec.throughput:.1f} images/s against "
             f"Engine.run's {run_ips:.1f}: beyond a factor {PROFILE_AGREE}")
    del params, mom, batch, eng
    _free(torch)
    return spec, got


def phase_opt_plan(torch, h100) -> tuple:
    """(b) ``launch/train.main`` in this process: CaffeNet at batch 256
    planned over ``OPT_SPEC`` for ``OPT_ROUNDS`` rounds, launch counts
    zeroed before and checked after, every loss finite; the round's ms and
    images/s from its metrics sink, the HE x SE report against a plan
    calibrated from that stream, and a plan with the card's measured spec
    (``h100``) beside the cluster's nodes. Then B2-B4 at the planned
    per-group batch and B1 bitwise with the plan's weights. -> (launch
    counts, the largest kernel errors)."""
    import argparse
    import tempfile
    from repro_torch import cluster
    from repro_torch.core import tree as T
    from repro_torch.kernels.fused_update import ops as fu
    from repro_torch.kernels.fused_update.ref import fused_update_ref
    from repro_torch.kernels.lowering_conv import autotune
    from repro_torch.launch import train as TR
    from repro_torch.models import cnn as C
    from repro_torch.obs.metrics import MetricRegistry
    from repro_torch.obs.report import calibrated_plan, hexse_report
    from repro_torch.optim.closed_form import grouped_coeffs, head_coeffs
    dev = torch.device("cuda")
    cfg = C.CAFFENET
    gen = torch.Generator(device=dev).manual_seed(14)
    params = C.init_params(gen, cfg)
    ns = argparse.Namespace(cluster_spec=OPT_SPEC, seq=64, batch=CNN_BATCH)
    plan = TR._plan(ns, params, cfg, say=lambda m: log(f"[opt:plan] {m}"))
    sizes, g = plan.allocation.microbatches, plan.g
    pgb = max(sizes)
    if len(set(sizes)) < 2:
        fail(f"the plan over {OPT_SPEC} has equal shares {sizes}")
    argv = ["--arch", "caffenet", "--batch", str(CNN_BATCH), "--steps",
            str(OPT_ROUNDS), "--lr", "0.01", "--momentum", "0.3",
            "--cluster-spec", OPT_SPEC, "--plan"]
    # the launcher autotunes the conv tiles before its engine (at batch
    # 256: --plan leaves --groups at 1); probed here, outside the counted
    # run, its own probe finds them cached and launches nothing
    C.autotune_conv_tiles(cfg, CNN_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        sink = str(Path(tmp) / "planned.jsonl")
        t0 = time.perf_counter()
        losses, got = _counted(torch, lambda: TR.main(
            argv + ["--metrics-out", sink]))
        wall = time.perf_counter() - t0
        reg, _ = MetricRegistry.from_jsonl(sink)
    autotune.clear_tile_cache()    # later phases run the default tiles
    want = _want_rounds(g, OPT_ROUNDS)
    log(f"[opt:plan] launch/train.py {' '.join(argv)}: {len(losses)} rounds "
        f"in {wall:.1f} s, launches {got} (want {want})")
    if got != want:
        fail(f"planned run: launch counts {got} != {want}")
    if len(losses) != OPT_ROUNDS or not all(math.isfinite(x)
                                            for x in losses):
        fail(f"planned run: losses {losses}")
    steady = reg.series("step_s").values[1:]
    waits = reg.series("data_wait_s").values[1:]
    med = statistics.median(steady)
    log(f"[opt:plan] planned round: g={g} mp={plan.mp} weights "
        f"{[round(w, 6) for w in plan.weights]} microbatches {sizes}, "
        f"per-group batch {pgb} ({g * pgb} examples a round after the "
        f"wrap-fill); step ms (host clock, rounds 2-{OPT_ROUNDS}) median "
        f"{med * 1e3:.1f} min {min(steady) * 1e3:.1f} max "
        f"{max(steady) * 1e3:.1f}; images/s {CNN_BATCH / med:.1f} of the "
        f"global batch, {g * pgb / med:.1f} examples computed; host data "
        f"wait median {statistics.median(waits) * 1e3:.1f} ms; losses "
        f"{[round(x, 4) for x in losses]}")
    for line in hexse_report(reg, calibrated_plan(
            reg, g=g, global_batch=CNN_BATCH)).render().splitlines():
        log(f"[opt:plan] {line}")
    # the card's measured spec beside the cluster's nodes
    cluster.register_device(dataclasses.replace(h100,
                                                name="gpu-h100-profiled"))
    ns.cluster_spec = "gpu-h100-profiled," + OPT_SPEC
    cplan = TR._plan(ns, params, cfg,
                     say=lambda m: log(f"[opt:calibrated] {m}"))
    log(f"[opt:calibrated] the H100 at its measured {h100.throughput:.1f} "
        f"images/s beside {OPT_SPEC}: g={cplan.g} microbatches "
        f"{cplan.allocation.microbatches}")

    # the kernels at the planned shapes
    errs = dict.fromkeys(("fused_update", "lowering_conv", "wgrad", "dgrad"),
                         0.0)
    _check_conv_layers(torch, gen, C.conv_layer_shapes(cfg, pgb),
                       f"planned batch {pgb} ", errs)
    slab = torch.cat([p.reshape(-1) for p in T.leaves(params)])
    v = torch.randn(slab.shape, generator=gen, device=dev) * 1e-2
    gs = torch.randn((g,) + tuple(slab.shape), generator=gen,
                     device=dev) * 1e-3
    kw = dict(lr=0.01, momentum=0.3, group_weights=plan.weights)
    for label, c in (("backbone", grouped_coeffs(g, **kw)),
                     ("merged-FC head", head_coeffs(g, **kw))):
        got_wv = fu.fused_update_cuda(slab, v, gs, c)
        want_wv = fused_update_ref(slab, v, gs, c)
        torch.cuda.synchronize()
        if not (torch.equal(got_wv[0], want_wv[0])
                and torch.equal(got_wv[1], want_wv[1])):
            fail(f"fused_update {label} with the plan's weights: differs "
                 "from the plain version (must be bitwise equal)")
        log(f"[check] fused_update {label} coefficients a={c.a} of the "
            f"plan's weights, slab of all 16 CaffeNet leaves "
            f"({slab.numel()} elements), g={g}: bitwise equal to the plain "
            "version ok")
    del params, slab, v, gs, got_wv, want_wv
    _free(torch)
    return got, errs


def phase_opt_algorithm1(torch) -> dict:
    """(c) ``algorithm1`` over ``make_runner(cnn_classify(),
    strategy="grouped-fused")`` on the card, once through the fused-update
    kernel and once through its plain version: the same decisions; then
    over the ``delayed`` Runner. Launch counts zeroed before each run and
    read after it."""
    import numpy as np
    from repro_torch.core import auto_optimizer as A
    from repro_torch.core import workload as W
    wl = W.cnn_classify()
    res, counts = {}, {}
    runs = (("grouped-fused", "cuda"), ("grouped-fused", "torch"),
            ("delayed", "cuda"))
    for strategy, upd in runs:
        runner = W.make_runner(wl, strategy=strategy, update_impl=upd)
        t0 = time.perf_counter()
        out, got = _counted(torch, lambda: A.algorithm1(
            runner, W.init_state(wl, seed=0), **OPT_ALG1))
        res[strategy, upd], counts[strategy, upd] = out, got
        log(f"[opt:alg1] {strategy} update={upd} "
            f"conv={W.cnn_config().conv_impl}: "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{len(out.losses)} trained steps, final g={out.g} mu={out.mu} "
            f"eta={out.eta}, launches {got}")
        for d in out.decisions:
            log(f"[opt:alg1]   {d.phase:5s} g={d.g} mu={d.mu} eta={d.eta} "
                f"loss={d.loss:.6f}")
        if not all(math.isfinite(d.loss) for d in out.decisions):
            fail(f"algorithm1 {strategy}/{upd}: a non-finite decision loss")
        # cnn_classify's one conv is fed by data: no dgrad on its path;
        # B1 only where the grouped step's update runs the kernel
        uses_b1 = (strategy, upd) == ("grouped-fused", "cuda")
        if (got["lowering_conv"] < 1 or got["wgrad"] < 1 or got["dgrad"]
                or (got["fused_update"] > 0) != uses_b1):
            fail(f"algorithm1 {strategy}/{upd}: launch counts {got}")
    kern, plain = res["grouped-fused", "cuda"], res["grouped-fused", "torch"]
    dk = [(d.phase, d.g, d.mu, d.eta) for d in kern.decisions]
    dp = [(d.phase, d.g, d.mu, d.eta) for d in plain.decisions]
    worst = max(abs(a.loss - b.loss) for a, b in zip(kern.decisions,
                                                     plain.decisions))
    log(f"[opt:alg1] kernel arm vs plain arm: decisions identical "
        f"{dk == dp}, decision losses bitwise {worst == 0.0} (max abs diff "
        f"{worst:.3e}), trained losses bitwise "
        f"{bool(np.array_equal(kern.losses, plain.losses))}")
    if dk != dp or worst > 1e-4:
        fail(f"algorithm1: the fused-update kernel's decisions {dk} differ "
             f"from the plain version's {dp} (max loss diff {worst:.3e})")
    _free(torch)
    total = dict.fromkeys(_train_counts(), 0)
    for got in counts.values():
        for k, n in got.items():
            total[k] += n
    return total


def phase_opt(torch, run_ips: float) -> tuple:
    """The optimizer phase: (a) the probe, (b) the planned run, (c)
    Algorithm 1. -> (launch counts, the largest kernel errors)."""
    h100, a = phase_opt_profile(torch, run_ips)
    b, errs = phase_opt_plan(torch, h100)
    c = phase_opt_algorithm1(torch)
    return {k: a[k] + b[k] + c[k] for k in a}, errs


# ---------------------------------------------------------------------------
# the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------

#: (arch, layers kept, rounds after the warm-up) of phase 14 (e)
FAMILY_TRAIN = (("qwen2-moe-a2.7b", 2, 3), ("mamba2-2.7b", 2, 2),
                ("recurrentgemma-2b", 3, 2))
FAMILY_SERVE = dict(batch=4, prompt_len=64, gen=16)
RG_PREFILL_BATCH, RG_PREFILL_SEQ = 2, 4096


def _tree_bytes(tree) -> int:
    from repro_torch.core import tree as T
    return sum(t.numel() * t.element_size() for t in T.leaves(tree))


def phase_moe_serve(torch) -> dict:
    """(a) ``ContinuousServer`` on qwen2-moe-a2.7b at full width and depth
    (bf16 weights from seed 0, the router fp32), the phase 5 traffic,
    served with scan and with parallel prefill, launch counts zeroed
    before each run and checked after it; then a profiled decode step."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.serving import (ContinuousServer, poisson_trace,
                                     sample_requests)
    cfg = get_config("qwen2-moe-a2.7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kw = dict(slots=8, page_size=16, max_seq=1024, attn_impl="cuda",
              device="cuda", seed=0)
    srv = ContinuousServer(cfg, **kw)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in T.leaves(srv.params))
    m = cfg.moe
    log(f"[moe] {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} head_dim "
        f"{cfg.resolved_head_dim} experts {m.num_experts} top-{m.top_k} of "
        f"width {m.d_ff_expert} + {m.num_shared_experts} shared, vocab "
        f"{cfg.vocab_size}: {n} params, weights "
        f"{_tree_bytes(srv.params) / 1e9:.2f} GB (router "
        f"{srv.params['blocks']['moe']['router'].dtype}), page pool "
        f"{_tree_bytes(srv.pages) / 1e9:.3f} GB, made in "
        f"{time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    reqs = sample_requests(poisson_trace(2.0, 8, seed=0), cfg,
                           prompt_range=(64, 256), gen_range=(16, 32), seed=0)
    lens = [len(r.prompt) for r in reqs]
    log(f"[moe] 8 Poisson requests (2 req/s): prompts {lens} gens "
        f"{[r.gen for r in reqs]}")
    t0 = time.perf_counter()
    srv.warmup(lens)
    log(f"[moe] warmup {time.perf_counter() - t0:.1f} s")
    scan = _drive(torch, srv, reqs, "scan", tag="moe")
    params = srv.params
    del srv
    torch.cuda.empty_cache()
    par_srv = ContinuousServer(cfg, params, prefill_mode="parallel", **kw)
    par_srv.warmup(lens)
    par = _drive(torch, par_srv, reqs, "parallel", tag="moe")
    same = sum(int((scan["rep"].tokens[r.rid] == par["rep"].tokens[r.rid]
                    ).sum()) for r in reqs)
    log(f"[moe] scan vs parallel prefill: {same}/{scan['rep'].total_tokens} "
        "generated tokens equal (bf16, and a parallel prefill's expert "
        "capacity is per prompt bucket: not required to be equal)")
    phase_profile(torch, par_srv, what=f"{cfg.name} decode step")
    log(f"[moe] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del par_srv, params
    _free(torch)
    return {"paged": scan["paged"] + par["paged"], "flash": par["flash"]}


def phase_moe_parity(torch) -> None:
    """(b) phase 6's fp32 checks at qwen2-moe-a2.7b's full width, 2
    layers."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), num_layers=2,
                              compute_dtype="float32")
    g = torch.Generator(device=torch.device("cuda")).manual_seed(6)
    _parity_fp32(torch, cfg, g, "moe:b")
    _free(torch)


def _finite_decode(torch):
    """Wrap ``transformer.decode_step`` so that every step's logits are
    checked finite on the card (one flag, read at the end)."""
    from repro_torch.models import transformer as M
    real = M.decode_step
    flag = {"ok": torch.ones((), dtype=torch.bool,
                             device=torch.device("cuda")), "n": 0}

    def checked(*a, **k):
        logits, cache = real(*a, **k)
        flag["ok"] &= torch.isfinite(logits).all()
        flag["n"] += 1
        return logits, cache

    M.decode_step = checked
    return flag, lambda: setattr(M, "decode_step", real)


def phase_family_serve(torch) -> None:
    """(c) ``launch/serve.serve`` on mamba2-2.7b and recurrentgemma-2b at
    full width and depth (bf16 weights from seed 0), every step's logits
    finite; then at full width, 2 layers (3 for the hybrid), fp32:
    ``decode_step`` over a prompt gives ``forward``'s last-position logits
    within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as M
    dev = torch.device("cuda")
    b, p, n = (FAMILY_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    for arch, layers in (("mamba2-2.7b", 2), ("recurrentgemma-2b", 3)):
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        flag, restore = _finite_decode(torch)
        try:
            toks, t_pre, t_dec = SV.serve(cfg, batch=b, prompt_len=p, gen=n,
                                          device=dev)
        finally:
            restore()
        if not bool(flag["ok"]) or flag["n"] != p + n - 1:
            fail(f"{arch} serve: logits finite {bool(flag['ok'])} over "
                 f"{flag['n']} decode steps (want {p + n - 1})")
        if toks.shape != (b, n) or not ((toks >= 0)
                                        & (toks < cfg.vocab_size)).all():
            fail(f"{arch} serve: tokens {toks}")
        log(f"[family:c] {arch} {cfg.num_layers} layers d_model "
            f"{cfg.d_model}, bf16, static batch {b} x prompt {p} + {n} "
            f"generated: prefill {b * p / t_pre:.1f} tok/s ({t_pre:.3f} s, "
            f"a decode-step loop), decode {b * (n - 1) / t_dec:.1f} tok/s "
            f"({t_dec / (n - 1) * 1e3:.2f} ms a step), every step's logits "
            f"finite, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        _free(torch)
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  compute_dtype="float32")
        g = torch.Generator(device=dev).manual_seed(7)
        params = M.init_params(g, cfg)
        toks = torch.randint(cfg.vocab_size, (b, p), generator=g, device=dev)
        with torch.no_grad():
            want = M.forward(params, {"tokens": toks}, cfg)[0][:, -1:]
            got, _ = M.prefill(params, M.init_cache(cfg, b, p, device=dev),
                               toks, cfg)
        err = _close(torch, f"{arch} decode_step over the prompt vs forward",
                     got, want)
        log(f"[family:c] {arch} widths, {layers} layers, fp32: decode_step "
            f"over {p} prompt tokens vs forward's last-position logits "
            f"max_abs_err={err:.3e} (tol 1e-4) ok")
        del params, want, got
        _free(torch)


def phase_rg_prefill(torch) -> dict:
    """(d) ``make_prefill_step`` on recurrentgemma-2b at full width, 3
    layers (one super-block), batch 2 x 4096: its local attention (hd 256,
    G = 10, window 2048) through the flash kernel and through the plain
    arm, both in bf16, each held to the fp32 prefill."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as M
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), num_layers=3)
    params = M.init_params(torch.Generator(device=dev).manual_seed(8), cfg)
    b, s = RG_PREFILL_BATCH, RG_PREFILL_SEQ
    toks = torch.randint(cfg.vocab_size, (b, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(9))
    shape = InputShape("prefill", s, b, "prefill")
    batch = {"tokens": toks}
    truth = S.make_prefill_step(dataclasses.replace(
        cfg, compute_dtype="float32"), shape)(params, batch)[0].float()
    out = {"torch": S.make_prefill_step(cfg, shape)(params, batch)[0]}
    fa.flash_attention.launches = 0
    out["cuda"] = S.make_prefill_step(cfg, shape, attn_impl="cuda")(
        params, batch)[0]
    torch.cuda.synchronize()
    flash = fa.flash_attention.launches
    n_attn = cfg.num_layers // len(cfg.hybrid.pattern)
    if flash != n_attn:
        fail(f"recurrentgemma prefill step: {flash} flash launches, want "
             f"{n_attn}")

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    err = {k: rel(v.float(), truth) for k, v in out.items()}
    if not torch.isfinite(out["cuda"]).all() or (
            err["cuda"] > err["torch"] or err["cuda"] > 2 * BF16_REL_RMS):
        fail(f"recurrentgemma prefill step bf16 last-position logits: "
             f"relative RMS error against fp32 {err['cuda']:.3e} (cuda) vs "
             f"{err['torch']:.3e} (torch); the cuda arm must be no further "
             f"and within {2 * BF16_REL_RMS}")
    log(f"[family:d] recurrentgemma-2b widths, {cfg.num_layers} layers, "
        f"make_prefill_step batch {b} x {s} (window {cfg.hybrid.local_window} "
        f"masks): last-position logits rel_rms against the fp32 prefill "
        f"cuda={err['cuda']:.3e} torch={err['torch']:.3e} (cuda must be <= "
        f"torch and <= {2 * BF16_REL_RMS}); {flash} flash launches ok")
    del params, truth, out
    _free(torch)
    return {"flash": flash}


def phase_family_train(torch) -> dict:
    """(e) ``Engine`` at g = 4 ``grouped-fused`` on each family at full
    width and reduced depth (``FAMILY_TRAIN``), as phase 12 (a) trains
    qwen2-7b; on the MoE round's own gradient stacks, B1 bitwise its plain
    version."""
    from repro_torch.configs import get_config
    fused = 0
    for arch, layers, rounds in FAMILY_TRAIN:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        tag = f"train:{cfg.arch_type}"
        host, mom, n = lm_host_params(torch, cfg, tag=tag)
        a = phase_lm_train(torch, cfg, host, mom, n, rounds=rounds, tag=tag,
                           profile=False)
        fused += a["fused_update"]
        if cfg.arch_type == "moe":
            phase_lm_update(torch, cfg, a["params"], a["mom"], a["batch"],
                            tag=tag)
        del a, host, mom
        _free(torch)
    return {"fused_update": fused}


def phase_families(torch) -> dict:
    """Phase 14: (a) MoE served at full width, (b) MoE parity, (c) the
    SSM and hybrid served, (d) B5 at recurrentgemma-2b's prefill, (e)
    training. -> the launch counts of the runs on the main path."""
    t0 = time.perf_counter()
    launches = phase_moe_serve(torch)
    phase_moe_parity(torch)
    phase_family_serve(torch)
    launches["flash"] += phase_rg_prefill(torch)["flash"]
    launches.update(phase_family_train(torch))
    log(f"[family] phase 14 in {time.perf_counter() - t0:.1f} s: launches "
        f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# the vlm and encdec families
# ---------------------------------------------------------------------------

WHISPER_SERVE = dict(batch=8, prompt_len=4, gen=60)
VISION_LAYERS = 40             # of 100: the run's ``reduced`` list
VISION_PREFILL = (4, 512)      # batch x text tokens, + 1024 image tokens
VISION_SERVE = dict(batch=4, prompt_len=32, gen=32)
VISION_PARITY_LAYERS = 5       # one super-block: 4 self blocks + 1 cross


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _prefill_arms(torch, cfg, params, batch, tag: str, want_flash: int):
    """``make_prefill_step`` through the plain arm and the flash kernel in
    bf16, each held to the fp32 prefill of the same weights: the kernel
    arm's last-position logits finite and no further from it than 1.5x
    the plain arm's (the port's bf16 contract). The kernel arm's flash
    launches are counted. Returns (its (logits, cache), launches)."""
    from repro_torch.configs import InputShape
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import steps as S
    b, s = batch["tokens"].shape
    shape = InputShape("prefill", s, b, "prefill")
    truth = S.make_prefill_step(dataclasses.replace(
        cfg, compute_dtype="float32"), shape)(params, batch)[0].float()
    plain = S.make_prefill_step(cfg, shape)(params, batch)[0]
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = S.make_prefill_step(cfg, shape, attn_impl="cuda")(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    flash = fa.flash_attention.launches
    if flash != want_flash:
        fail(f"{cfg.name} prefill step: {flash} flash launches, want "
             f"{want_flash}")
    err = {"cuda": _rel(out[0], truth), "torch": _rel(plain, truth)}
    if not torch.isfinite(out[0]).all() or out[0].shape != (
            b, 1, cfg.vocab_size) or err["cuda"] > 1.5 * err["torch"]:
        fail(f"{cfg.name} prefill step bf16 last-position logits "
             f"{tuple(out[0].shape)}: relative RMS error against fp32 "
             f"{err['cuda']:.3e} (cuda) vs {err['torch']:.3e} (torch); the "
             "cuda arm must be finite and within 1.5x the torch arm's")
    log(f"[{tag}] {cfg.name} {cfg.num_layers} layers, make_prefill_step "
        f"batch {b} x {s}: {ms:.1f} ms (host clock, the kernel arm), "
        f"last-position logits rel_rms against the fp32 prefill cuda="
        f"{err['cuda']:.3e} torch={err['torch']:.3e} (cuda <= 1.5 x "
        f"torch); {flash} flash launches ok")
    return out, flash


def _prefill_parity_fp32(torch, cfg, params, batch, tag: str) -> None:
    """fp32: ``make_prefill_step``'s kernel arm within 1e-4 of the plain
    arm on the logits and on every cache leaf (the self and cross K/V)."""
    from repro_torch.configs import InputShape
    from repro_torch.core import tree as T
    from repro_torch.launch import steps as S
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    b, s = batch["tokens"].shape
    shape = InputShape("prefill", s, b, "prefill")
    out = {impl: list(S.make_prefill_step(cfg, shape, attn_impl=impl)(
        params, batch)) for impl in ("torch", "cuda")}
    worst = max(_close(torch, f"{cfg.name} prefill {path}", a, w)
                for (path, a), w in zip(T.leaves_with_path(out["cuda"]),
                                        T.leaves(out["torch"])))
    log(f"[{tag}] {cfg.name} widths, {cfg.num_layers} layers, fp32, "
        f"make_prefill_step batch {b} x {s}: cuda vs torch logits and "
        f"{len(T.leaves(out['cuda'])) - 1} cache leaves max_abs_err="
        f"{worst:.3e} (tol 1e-4) ok")


def _serve_filled(torch, cfg, params, cache, prompts, gen: int, tag: str):
    """``transformer.prefill`` over ``prompts`` then ``gen - 1`` decode
    steps on ``cache`` (its cross K/V filled by the caller): every step's
    logits finite, the tokens in the vocabulary. Returns (prefill s,
    decode s a step)."""
    from repro_torch.models import transformer as M
    b, p = prompts.shape
    flag, restore = _finite_decode(torch)
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = M.prefill(params, cache, prompts, cfg)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            outs = [tok]
            t0 = time.perf_counter()
            for pos in range(p, p + gen - 1):
                logits, cache = M.decode_step(params, cache, tok, pos, cfg)
                tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                outs.append(tok)
            torch.cuda.synchronize()
            t_dec = (time.perf_counter() - t0) / max(gen - 1, 1)
    finally:
        restore()
    toks = torch.cat(outs, dim=1)
    if not bool(flag["ok"]) or flag["n"] != p + gen - 1 or toks.shape != (
            b, gen) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{cfg.name} served with filled cross caches: logits finite "
             f"{bool(flag['ok'])} over {flag['n']} steps (want "
             f"{p + gen - 1}), tokens {tuple(toks.shape)}")
    log(f"[{tag}] {cfg.name} served batch {b} x prompt {p} + {gen} "
        f"generated, cross K/V filled from the forward: prefill "
        f"{b * p / t_pre:.1f} tok/s ({t_pre:.3f} s, a decode-step loop), "
        f"decode {b / t_dec:.1f} tok/s ({t_dec * 1e3:.2f} ms a step), every "
        "step's logits finite")
    return t_pre, t_dec


def _profile_decode(torch, cfg, params, cache, b: int, pos: int,
                    tag: str) -> None:
    """One ``decode_step`` of a batch of ``b`` on its filled ``cache`` at
    ``pos``, profiled (each call rewrites the same cache slot)."""
    from repro_torch.models import transformer as M
    tok = torch.zeros((b, 1), dtype=torch.int32, device=torch.device("cuda"))
    with torch.no_grad():
        _profile_fn(torch, lambda: M.decode_step(params, cache, tok, pos,
                                                 cfg)[0].cpu(),
                    f"{cfg.name} decode step, batch {b} at position {pos} "
                    f"({tag})", ("flash_fwd",))


def phase_whisper(torch) -> dict:
    """(a) whisper-base at full width and depth (6 + 6 layers, d_model 512,
    8 heads of 64; fp32 params from seed 0, bf16 compute): the prefill
    step over 8 x 1500 stub audio frames and a 4-token prompt through both
    arms (the encoder's B5 non-causal over 1500 frames, the decoder's
    causal), the fp32 arms' parity, the cross K/V filled from that
    forward's cache and 60 tokens generated, a decode step profiled, then
    ``launch/serve.serve`` as the reference runs it (zero cross
    caches)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.launch import serve as SV
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as M
    dev = torch.device("cuda")
    cfg = get_config("whisper-base")
    b, p, n = (WHISPER_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in T.leaves(params))
    log(f"[vlm:a] {cfg.name} {cfg.encoder_layers} + {cfg.num_layers} layers "
        f"d_model {cfg.d_model} heads {cfg.num_heads} of "
        f"{cfg.resolved_head_dim} vocab {cfg.vocab_size}: {n_params} params "
        f"({_tree_bytes(params) / 1e6:.1f} MB {cfg.param_dtype}), "
        f"{cfg.encoder_seq} frames a row")
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(cfg.vocab_size, (b, p), generator=g,
                                     device=dev)}
    batch.update(S.modality_inputs(cfg, (b,), seed=0, device=dev))
    (_, fwd), flash = _prefill_arms(
        torch, cfg, params, batch, "vlm:a",
        want_flash=cfg.encoder_layers + cfg.num_layers)
    _prefill_parity_fp32(torch, cfg, params, batch, "vlm:a")
    cache = M.init_cache(cfg, b, p + n, device=dev)
    for k in ("ck", "cv"):
        cache["blocks"][k].copy_(fwd["blocks"][k])
    del fwd
    _serve_filled(torch, cfg, params, cache, batch["tokens"], n, "vlm:a")
    _profile_decode(torch, cfg, params, cache, b, p + n - 1,
                    "cross K/V filled")
    del cache, params
    _free(torch)
    toks, t_pre, t_dec = SV.serve(cfg, batch=b, prompt_len=p, gen=n,
                                  device=dev)
    if toks.shape != (b, n) or not ((toks >= 0)
                                    & (toks < cfg.vocab_size)).all():
        fail(f"whisper-base serve: tokens {toks}")
    log(f"[vlm:a] launch/serve.serve (zero cross caches, as the reference): "
        f"prefill {b * p / t_pre:.1f} tok/s, decode "
        f"{b * (n - 1) / t_dec:.1f} tok/s ({t_dec / (n - 1) * 1e3:.2f} ms a "
        f"step); peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        "GB")
    _free(torch)
    return {"flash": flash}


def phase_vision(torch) -> dict:
    """(b) llama-3.2-vision-90b at full published width and
    ``VISION_LAYERS`` of its 100 layers (bf16 weights from seed 0, drawn a
    layer at a time): the prefill step at 4 x 512 text tokens + 1024 stub
    image tokens a row through both arms (B5 causal, 64 query heads on 8
    kv heads of 128), then a batch of 4 served, prompt 32 + 32 generated,
    the image K/V copied from the forward's cache into ``init_cache``'s
    tree, and a decode step profiled; then the fp32 arms' parity at one
    super-block."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as M
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b"),
                              num_layers=VISION_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in T.leaves(params))
    per = cfg.cross_attn_every
    n_cross = cfg.num_layers // per
    log(f"[vlm:b] {cfg.name} {cfg.num_layers} layers ({n_cross} x "
        f"({per - 1} self + 1 cross) + {cfg.num_layers % per} self) d_model "
        f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} of "
        f"{cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size}: "
        f"{n_params} params, {_tree_bytes(params) / 1e9:.2f} GB "
        f"{cfg.param_dtype}, made in {time.perf_counter() - t0:.1f} s, peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    b, s = VISION_PREFILL
    g = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(cfg.vocab_size, (b, s), generator=g,
                                     device=dev)}
    batch.update(S.modality_inputs(cfg, (b,), seed=0, device=dev))
    n_self = cfg.num_layers - n_cross
    (_, fwd), flash = _prefill_arms(torch, cfg, params, batch, "vlm:b",
                                    want_flash=n_self)
    log(f"[vlm:b] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        "GB after the prefill steps")
    bs, p, n = (VISION_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    cache = M.init_cache(cfg, bs, p + n, device=dev)
    for k in ("ck", "cv"):                  # the forward's "super" ck / cv
        cache["super"][k].copy_(fwd["super"][k][:, :bs])
    del fwd
    _free(torch)
    _serve_filled(torch, cfg, params, cache, batch["tokens"][:bs, :p], n,
                  "vlm:b")
    _profile_decode(torch, cfg, params, cache, bs, p + n - 1,
                    "image K/V filled")
    PEAKS["vlm:b"] = torch.cuda.max_memory_allocated()
    log(f"[vlm:b] peak memory {PEAKS['vlm:b'] / 1e9:.2f} GB")
    del cache, params
    _free(torch)
    small = dataclasses.replace(cfg, num_layers=VISION_PARITY_LAYERS)
    params = M.init_params(torch.Generator(device=dev).manual_seed(3), small)
    _prefill_parity_fp32(torch, small, params,
                         {k: v[:2, :256] if k == "tokens" else v[:2]
                          for k, v in batch.items()}, "vlm:b")
    del params
    _free(torch)
    return {"flash": flash}


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------

REPLAY_COMMITS = 32            # commits replayed, one group batch each
REPLAY_G = 4


def _replay_run(torch, engine, params, batches, label: str):
    """``Engine.run`` under ``trace-replay`` over the host ``batches``,
    with the training kernels' launch counts zeroed before it and checked
    after it (per commit: lowering conv 5, wgrad 5, dgrad 4; no fused
    update: the replay updates in plain code, as the reference does),
    every loss finite. Returns (counts, losses, final params)."""
    from repro_torch.core import tree as T
    from repro_torch.optim.sgd import init_momentum
    counts = _train_counts()
    for w in counts.values():
        w.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    final, _, losses = engine.run(params, init_momentum(params),
                                  iter(batches), steps=REPLAY_COMMITS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    got = {k: w.launches for k, w in counts.items()}
    n = len(params["conv"])               # the first conv has no dgrad
    want = {"lowering_conv": n * REPLAY_COMMITS,
            "wgrad": n * REPLAY_COMMITS, "dgrad": (n - 1) * REPLAY_COMMITS,
            "fused_update": 0}
    finite = all(math.isfinite(x) for x in losses)
    if got != want or len(losses) != REPLAY_COMMITS or not finite:
        fail(f"replay {label}: launches {got} (want {want}), "
             f"{len(losses)} losses, finite {finite}")
    ms = engine.telemetry.step_s[-1] / REPLAY_COMMITS * 1e3
    batch_bytes = sum(x.nbytes for b in batches for x in b.values())
    version = sum(t.numel() * t.element_size() for t in T.leaves(params))
    log(f"[replay] {label}: {REPLAY_COMMITS} commits in "
        f"{engine.telemetry.step_s[-1] * 1e3:.1f} ms, {ms:.2f} ms a commit "
        f"(host clock, the batches on the card), losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, peak memory above the start {peak / 1e9:.3f} GB "
        f"(the batches {batch_bytes / 1e9:.3f} GB, a CaffeNet version {version / 1e6:.1f} MB); launches {got} "
        "ok")
    return got, losses, final


def phase_replay(torch) -> dict:
    """Trace replay at full CaffeNet width (28.8 M fp32 params, group batch
    64, the synthetic image stream): ``Engine(strategy="trace-replay")``
    along a ``queue_sim`` trace (g = 4, exponential service) with ``scan``
    (an R-deep ring of versions), then along ``EventTrace.round_robin(4,
    32, "grouped")`` with ``fused`` and with ``scan``, which must agree
    within 1e-4 (losses and final params); then the first replay
    profiled. Every commit's gradient runs B2-B4. -> the launch counts."""
    from repro_torch.core import queue_sim
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import DataConfig, SyntheticImages
    from repro_torch.engine import Engine
    from repro_torch.exec import EventTrace
    import numpy as np
    from repro_torch.exec.replay import _read_slots
    from repro_torch.models import cnn as C
    dev = torch.device("cuda")
    cfg = C.CAFFENET
    params = C.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    t0 = time.perf_counter()
    batches = list(SyntheticImages(DataConfig(
        batch_size=CNN_GROUP_BATCH, image_size=cfg.image_size,
        channels=cfg.in_channels, num_classes=cfg.num_classes,
        seed=0)).batches(REPLAY_COMMITS))
    log(f"[replay] {REPLAY_COMMITS} host batches of {CNN_GROUP_BATCH} "
        f"images made in {time.perf_counter() - t0:.1f} s (set-up)")
    _, qtrace = queue_sim.simulate(g=REPLAY_G, t_conv=1.0, t_fc=0.05,
                                   iters=REPLAY_COMMITS, exponential=True,
                                   seed=0, return_trace=True)
    qtrace = qtrace.truncate(REPLAY_COMMITS)
    grouped = EventTrace.round_robin(REPLAY_G, REPLAY_COMMITS, "grouped")
    total = dict.fromkeys(("lowering_conv", "wgrad", "dgrad"), 0)
    runs = {}
    for label, trace, impl in (("queue_sim", qtrace, "scan"),
                               ("round-robin", grouped, "fused"),
                               ("round-robin", grouped, "scan")):
        eng = Engine(lambda p, b: C.loss_fn(p, b, cfg),
                     strategy="trace-replay", trace=trace, lr=0.01,
                     momentum=0.3, replay_impl=impl, device=dev)
        ring = (f"R = {_read_slots(trace, None)[0]}" if impl == "scan"
                else "no ring")
        got, losses, final = _replay_run(
            torch, eng, params, batches,
            f"{label} g={trace.num_groups} {impl} ({ring}, staleness mean "
            f"{float(trace.staleness.mean()):.2f} max {trace.max_staleness})")
        runs[(label, impl)] = (losses, final)
        for k in total:
            total[k] += got[k]
        del eng
        _free(torch)
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches])).to(
        dev) for k in batches[0]}
    eng = Engine(lambda p, b: C.loss_fn(p, b, cfg), strategy="trace-replay",
                 trace=qtrace, lr=0.01, momentum=0.3, device=dev)
    _profile_fn(torch, lambda: eng.replay(params, stacked),
                f"replay of {REPLAY_COMMITS} commits, queue_sim trace, scan",
                ("lowering_conv", "split_transpose", "slice_sum", "wgrad",
                 "dgrad", "fused_update"), reps=1)
    del eng, stacked
    (lf, pf), (ls, ps) = (runs[("round-robin", i)] for i in ("fused",
                                                            "scan"))
    e_loss = max(abs(a - b) for a, b in zip(lf, ls))
    e_par = max((a - b).abs().max().item()
                for a, b in zip(T.leaves(pf), T.leaves(ps)))
    if e_loss > 1e-4 or e_par > 1e-4:
        fail(f"replay round-robin: fused vs scan losses {e_loss:.3e}, "
             f"params {e_par:.3e} (tol 1e-4)")
    log(f"[replay] round-robin fused vs scan: losses max_abs_err "
        f"{e_loss:.3e}, final params max_abs_err {e_par:.3e} (tol 1e-4) ok")
    del runs, params, batches
    _free(torch)
    return total


# ---------------------------------------------------------------------------
# the conv-tile autotuner
# ---------------------------------------------------------------------------

AUTOTUNE_ROUNDS = 5            # the launcher's run in (d), the first a warm-up


def _todays_tiles(w_shape):
    """The fixed rule an unprobed layer runs, recomputed here from its
    definition: the forward's and wgrad's width 96 output channels where
    they take no more tiles than 64 do, dgrad's 96 input channels where
    they pad no more than 64 do; wgrad aimed at three blocks an SM of
    132."""
    from repro_torch.kernels.lowering_conv import bwd

    def fewest(c):
        return 96 if math.ceil(c / 96) < math.ceil(c / 64) else 64

    def least_pad(c):
        return 96 if math.ceil(c / 96) * 96 <= math.ceil(c / 64) * 64 else 64
    return bwd.ConvTiles(fewest(w_shape[3]), fewest(w_shape[3]), 3 * 132,
                         least_pad(w_shape[2]))


def phase_autotune_check(torch) -> dict:
    """(a) every candidate tile of B2, B3 and B4 at CaffeNet's five layers
    at group batch 64 against the plain versions (dgrad at layers 2-5, the
    ones the path runs it at), the forward's residual bitwise; (b) the
    footprint model against each compiled kernel's own figure. -> the
    largest errors."""
    from repro_torch.kernels.lowering_conv import autotune, bwd
    from repro_torch.kernels.lowering_conv import lowering_conv as lc
    from repro_torch.kernels.lowering_conv.ref import lower
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    errs = dict.fromkeys(("lowering_conv", "wgrad", "dgrad"), 0.0)
    n = 0
    for i, (xs, ws, s) in enumerate(caffenet_layers()):
        kh, kw, cin, cout = ws
        x = torch.randn(xs, generator=g, device=dev)
        w = torch.randn(ws, generator=g, device=dev) * 0.05
        low_ref = lower(x, kh, kw, s)
        y_ref = (low_ref @ w.reshape(kh * kw * cin, cout))
        dflt = autotune.DEFAULT_TILES(ws)
        cands = autotune.tile_candidates(xs, ws, s, device=dev)
        tag = f"conv{i + 1} x{xs} w{ws} s{s}"
        for bn in cands["fwd"]:
            t = dataclasses.replace(dflt, fwd_bn=bn)
            y, low = lc.lowering_conv_cuda(x, w, stride=s,
                                           return_lowered=True, tiles=t)
            errs["lowering_conv"] = max(errs["lowering_conv"], compare_fp32(
                torch, f"lowering_conv {tag} BN {bn}", y,
                y_ref.reshape(y.shape)))
            if not torch.equal(low.reshape(low_ref.shape), low_ref):
                fail(f"lowering_conv {tag} BN {bn}: the residual differs "
                     "from ref.lower")
            n += 1
        dy = torch.randn(y.shape, generator=g, device=dev)
        del y, y_ref
        dw_ref = bwd.wgrad_ref(low_ref, dy, ws)
        for bn, blocks in cands["wgrad"]:
            t = dataclasses.replace(dflt, wgrad_bn=bn, wgrad_blocks=blocks)
            rows, slices = bwd.wgrad_slices(low_ref.shape[0], low.shape[-1],
                                            cout, bn, blocks)
            errs["wgrad"] = max(errs["wgrad"], compare_fp32(
                torch, f"wgrad {tag} BN {bn} blocks {blocks} ({slices} "
                f"slices of {rows} rows)",
                bwd.wgrad_cuda(low, dy, ws, tiles=t), dw_ref))
            n += 1
        del dw_ref, low, low_ref
        if i > 0:                      # conv1 has needs_dgrad=False
            dx_ref = bwd.dgrad_ref(dy, w, xs, s)
            for bn in cands["dgrad"]:
                t = dataclasses.replace(dflt, dgrad_bn=bn)
                errs["dgrad"] = max(errs["dgrad"], compare_fp32(
                    torch, f"dgrad {tag} BN {bn}",
                    bwd.dgrad_cuda(dy, w, xs, stride=s, tiles=t), dx_ref))
                n += 1
            del dx_ref
        del x, w, dy
        _free(torch)
    log(f"[autotune:a] {n} candidate tiles of B2-B4 at CaffeNet's five "
        "layers, group batch 64: every one within the plain versions' "
        "limits ok")
    for pass_ in ("fwd", "wgrad", "dgrad"):
        for bn in lc.BLOCK_N:
            model = lc.smem_bytes(pass_=pass_, block_n=bn)
            built = lc.kernel_smem_bytes(pass_, bn)
            if built != model:
                fail(f"smem_bytes {pass_} BN {bn}: the model says {model}, "
                     f"the compiled kernel {built}")
            log(f"[autotune:b] {pass_} BN {bn}: {model} bytes of shared "
                f"memory a block, the kernel's own figure {built} ok")
    return errs


def phase_autotune_probe(torch) -> None:
    """(c) ``autotune_conv_tiles(CAFFENET, 64)`` under a span tracer: each
    candidate's time, each layer's winner beside ``DEFAULT_TILES``, the
    probe's wall time; ``DEFAULT_TILES`` equal to today's rule recomputed
    and bitwise its launches; each kernel summed over one group's five
    layers at the chosen and at the default tiles (CUDA events, L2
    flushed)."""
    from repro_torch.kernels.lowering_conv import autotune, bwd
    from repro_torch.kernels.lowering_conv import lowering_conv as lc
    from repro_torch.models import cnn as C
    from repro_torch.obs import spans
    dev = torch.device("cuda")
    autotune.clear_tile_cache()
    tracer = spans.Tracer()
    t0 = time.perf_counter()
    with spans.install(tracer):
        tiles = C.autotune_conv_tiles(C.CAFFENET, CNN_GROUP_BATCH)
    wall = time.perf_counter() - t0
    recs = tracer.records()
    layers = caffenet_layers()
    n_cand = 0
    for i, outer in enumerate(r for r in recs
                              if r.name == "autotune.conv_tiles"):
        for c in recs:
            if c.name == "autotune.candidate" and c.parent == outer.index:
                a = c.attrs
                log(f"[autotune:c] conv{i + 1} {a['pass_']} BN "
                    f"{a['block_n']}" + (f" blocks {a['wgrad_blocks']}"
                                         if a["wgrad_blocks"] else "")
                    + f": {a['min_us']:.1f} us (host clock, min of 5)")
                n_cand += 1
        log(f"[autotune:c] conv{i + 1}: chosen {tiles[i]}, default "
            f"{autotune.DEFAULT_TILES(layers[i][1])}")
    log(f"[autotune:c] probe of {n_cand} candidates at CaffeNet's five "
        f"layers, group batch {CNN_GROUP_BATCH}: {wall:.2f} s wall")
    g = torch.Generator(device=dev).manual_seed(18)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    tot = {k: {"chosen": 0.0, "default": 0.0}
           for k in lc.PASS_KERNELS.values()}
    for i, (xs, ws, s) in enumerate(layers):
        dflt = autotune.DEFAULT_TILES(ws)
        if dflt != _todays_tiles(ws):
            fail(f"conv{i + 1}: DEFAULT_TILES {dflt} is not today's rule "
                 f"{_todays_tiles(ws)}")
        x = torch.randn(xs, generator=g, device=dev)
        w = torch.randn(ws, generator=g, device=dev) * 0.05
        y, low = lc.lowering_conv_cuda(x, w, stride=s, return_lowered=True)
        dy = torch.randn(y.shape, generator=g, device=dev)
        calls = {
            "lowering_conv": lambda t: lc.lowering_conv_cuda(
                x, w, stride=s, return_lowered=True, tiles=t),
            "wgrad": lambda t: bwd.wgrad_cuda(low, dy, ws, tiles=t),
            "dgrad": lambda t: bwd.dgrad_cuda(dy, w, xs, stride=s, tiles=t)}
        for name, fn in calls.items():
            if name == "dgrad" and i == 0:
                continue
            a, b = fn(None), fn(dflt)
            same = all(torch.equal(u, v) for u, v in zip(
                a if isinstance(a, tuple) else (a,),
                b if isinstance(b, tuple) else (b,)))
            if not same:
                fail(f"{name} conv{i + 1}: DEFAULT_TILES launch differs from "
                     "the launch that leaves the tiles out")
            for which, t in (("chosen", tiles[i]), ("default", dflt)):
                tot[name][which] += cuda_ms(torch, lambda: fn(t), iters=10,
                                            flush=flush)
        del x, w, y, low, dy
    log("[autotune:c] DEFAULT_TILES is today's rule at all five layers and "
        "bitwise the launches that leave the tiles out ok")
    for name, t in tot.items():
        log(f"[autotune:c] {name} summed over one group's layers (batch "
            f"{CNN_GROUP_BATCH}): chosen tiles {t['chosen']:.4f} ms, default "
            f"tiles {t['default']:.4f} ms")
    del flush
    _free(torch)


def phase_autotune_launch(torch, run_ips: float) -> dict:
    """(d) ``launch/train.main`` on caffenet, batch 256, g = 4,
    ``AUTOTUNE_ROUNDS`` rounds, with ``--trace-out`` and ``--metrics-out``
    into a temporary directory and the tile cache empty: the launcher
    probes (counted: the candidate spans say how many launches each
    probe made) and trains; the trace passes ``obs.validate`` with the
    autotune and engine spans; its round's ms beside phase 8's at the
    default tiles. -> the launch counts."""
    import json
    import tempfile
    from repro_torch.kernels.lowering_conv import autotune
    from repro_torch.kernels.lowering_conv.lowering_conv import PASS_KERNELS
    from repro_torch.launch import train as TR
    from repro_torch.obs import validate
    from repro_torch.obs.metrics import MetricRegistry
    autotune.clear_tile_cache()
    argv = ["--arch", "caffenet", "--batch", str(CNN_BATCH), "--groups",
            str(CNN_GROUPS), "--steps", str(AUTOTUNE_ROUNDS), "--lr", "0.01",
            "--momentum", "0.3"]
    with tempfile.TemporaryDirectory() as tmp:
        trace, sink = str(Path(tmp) / "t.json"), str(Path(tmp) / "m.jsonl")
        t0 = time.perf_counter()
        losses, got = _counted(torch, lambda: TR.main(
            argv + ["--trace-out", trace, "--metrics-out", sink]))
        wall = time.perf_counter() - t0
        bad = validate.check_trace(trace, [
            "autotune.conv_tiles", "autotune.candidate", "engine.run",
            "engine.step", "engine.block_until_ready"]) + \
            validate.check_metrics(sink, ["step_s", "data_wait_s"])
        if bad:
            fail(f"launcher trace/metrics: {bad}")
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        reg, _ = MetricRegistry.from_jsonl(sink)
    probes = dict.fromkeys(PASS_KERNELS.values(), 0)
    for e in events:
        if e.get("name") == "autotune.candidate":
            probes[PASS_KERNELS[e["args"]["pass_"]]] += e["args"]["launches"]
    want = _want_rounds(CNN_GROUPS, AUTOTUNE_ROUNDS)
    for k, n in probes.items():
        want[k] += n
    log(f"[autotune:d] launch/train.py {' '.join(argv)} --trace-out "
        f"--metrics-out: {len(losses)} rounds in {wall:.1f} s; launches "
        f"{got} (want {want}: the rounds' and the probes' {probes}); trace "
        f"and metrics valid ({len(events)} trace events) ok")
    if got != want:
        fail(f"autotuned launcher run: launch counts {got} != {want}")
    if len(losses) != AUTOTUNE_ROUNDS or not all(math.isfinite(x)
                                                 for x in losses):
        fail(f"autotuned launcher run: losses {losses}")
    steady = reg.series("step_s").values[1:]
    med = statistics.median(steady)
    log(f"[autotune:d] round at the autotuned tiles: median "
        f"{med * 1e3:.1f} ms (host clock, rounds 2-{AUTOTUNE_ROUNDS}; min "
        f"{min(steady) * 1e3:.1f} max {max(steady) * 1e3:.1f}), "
        f"{CNN_BATCH / med:.1f} images/s; phase 8 at the default tiles "
        f"{CNN_BATCH / run_ips * 1e3:.1f} ms, {run_ips:.1f} images/s")
    autotune.clear_tile_cache()
    _free(torch)
    return got


def phase_reckon(torch) -> None:
    """Parameter counts from meta params (``launch/steps.params_specs``)
    for every arch at full size, and the bytes reckoned for the runs whose
    peaks phases 12, 14 and 15 measured: (4 + g)·P·4 B for training at
    g = 4 (fp32 params and momentum in and out, g gradient stacks), the
    bf16 weights for the llama-3.2-vision serving run. Readings, not a
    check."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch import params_util as PU
    from repro_torch.launch import steps as S
    for arch in list_archs():
        cfg = get_config(arch)
        spec = S.params_specs(cfg)
        log(f"[reckon] {arch}: param_count {PU.param_count(spec)}, "
            f"param_bytes {PU.param_bytes(spec)} ({cfg.param_dtype}), "
            f"active_param_count {PU.active_param_count(spec, cfg)}")
    for tag, arch, layers, what in (
            ("lm:a", "qwen2-7b", LM_LAYERS, "train"),
            ("train:moe", "qwen2-moe-a2.7b", 2, "train"),
            ("vlm:b", "llama-3.2-vision-90b", VISION_LAYERS, "serve")):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        p = PU.param_count(S.params_specs(cfg))
        if what == "train":
            model = f"(4 + {LM_GROUPS}) x P x 4 B = " \
                    f"{(4 + LM_GROUPS) * p * 4 / 1e9:.2f} GB"
        else:
            model = f"bf16 weights P x 2 B = {p * 2 / 1e9:.2f} GB"
        peak = PEAKS.get(tag)
        log(f"[reckon] {arch} at {layers} layers ({tag}): P = {p}, {model}; "
            f"measured peak " + (f"{peak / 1e9:.2f} GB" if peak is not None
                                 else "not measured in this run"))


def phase_autotune(torch, run_ips: float) -> tuple:
    """Phase 17: (a)-(d) and the reckoned bytes. -> (launch counts of the
    launcher's run, the largest kernel errors)."""
    t0 = time.perf_counter()
    errs = phase_autotune_check(torch)
    phase_autotune_probe(torch)
    got = phase_autotune_launch(torch, run_ips)
    phase_reckon(torch)
    log(f"[autotune] phase 17 in {time.perf_counter() - t0:.1f} s")
    return got, errs


# ---------------------------------------------------------------------------
# The dry-run on meta tensors, held to the card
# ---------------------------------------------------------------------------

DRY_ITERS = 5                  # timed steps of (b) and (c), after warm-ups
DRY_DECODE_BATCH, DRY_DECODE_SEQ = 8, 1024   # phase 5's slots and max_seq


def phase_dryrun_smoke() -> None:
    """(a) ``launch/dryrun.host_smoke_one`` for ``HOST_SMOKE_ARCHS`` on
    the (1, 4, 2) layout, on meta tensors (the host's CPU reckons them):
    a regression raises."""
    from repro_torch.launch import dryrun as DR
    for arch in DR.HOST_SMOKE_ARCHS:
        r = DR.host_smoke_one(arch, groups=1, data=4, mp=2, verbose=False)
        m, c = r["memory"], r["collectives"]
        log(f"[dryrun:a] {arch} {r['mesh']} hostsmoke (rank batch "
            f"{r['rank_batch']} x {r['seq_len']}): args/rank "
            f"{m['argument_bytes']} B (bound {m['argument_bound_bytes']:.0f}),"
            f" mp-sharded leaves {r['mp_sharded_param_leaves']}/"
            f"{r['param_leaves']}, flops {r['flops']}, temp "
            f"{m['temp_bytes']} B, exchange {c['received']} B in "
            f"{c['gathers']} gathers, reckoned in {r['reckon_s']} s ok")


def phase_dryrun_train(torch) -> None:
    """(b) qwen2-7b at full width, ``LM_LAYERS`` layers, bf16 compute,
    remat: ``steps.make_train_step`` at ``LM_BATCH`` x ``LM_SEQ`` counted
    on meta and on the card (the same integer FLOPs, or fail), the card's
    peak memory beside the meta reckoning, the step's median time beside
    the roofline."""
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.core import tree as T
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps as S
    from repro_torch.launch.meta_count import count_step
    from repro_torch.launch.params_util import param_bytes
    from repro_torch.launch.roofline import Roofline, analytic_hbm_bytes
    from repro_torch.models import transformer as M
    cfg = lm_config()
    shape = InputShape("lm", LM_SEQ, LM_BATCH, "train")
    step = S.make_train_step(cfg, TrainConfig(learning_rate=LM_LR,
                                              momentum=LM_MU), shape)
    t0 = time.perf_counter()
    spec = S.params_specs(cfg)
    spec_batch = S.batch_specs(cfg, shape)
    meta = count_step(step, spec, T.tree_map(
        lambda x: torch.empty(x.shape, dtype=cfg.dtype("mom"),
                              device="meta"), spec), spec_batch)
    state = DR.rank_state(spec, cfg, {"group": 1, "data": 1, "mp": 1},
                          train=True)["state_bytes"]
    est = state + _tree_bytes(spec_batch) + meta.peak_live_bytes
    t_meta = time.perf_counter() - t0
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    params = M.init_params(gen, cfg)
    mom = T.tree_map(torch.zeros_like, params)
    batch = {k: torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                              generator=gen, device="cuda",
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    _free(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card = count_step(step, params, mom, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"[dryrun:b] qwen2-7b {LM_LAYERS} layers (reduced: num_layers 28 "
        f"-> {LM_LAYERS}), make_train_step {LM_BATCH} x {LM_SEQ}, "
        f"{cfg.compute_dtype} compute, remat {cfg.remat}: flops meta "
        f"{meta.flops} card {card.flops} ({meta.flops_by_op} / "
        f"{card.flops_by_op}); live-bytes peak beyond the inputs meta "
        f"{meta.peak_live_bytes} card {card.peak_live_bytes}; meta counted "
        f"in {t_meta:.1f} s")
    if card.flops != meta.flops:
        fail(f"the train step counts {card.flops} FLOPs on the card and "
             f"{meta.flops} on meta tensors")
    ms = cuda_ms(torch, lambda: step(params, mom, batch), iters=DRY_ITERS,
                 warmup=1)
    roof = Roofline(flops=float(meta.flops), hbm_bytes=analytic_hbm_bytes(
        cfg, shape, 1, params_bytes_global=param_bytes(spec)),
        collective_bytes=0.0, chips=1)
    log(f"[dryrun:b] peak memory card {peak} B ({peak / 1e9:.2f} GB, "
        f"torch.cuda.max_memory_allocated over the counted step) vs meta "
        f"peak_per_chip_est {est} B ({est / 1e9:.2f} GB: state {state} + "
        f"batch + temp {meta.peak_live_bytes}); step median {ms:.3f} ms "
        f"(CUDA events, {DRY_ITERS} steps after 2 warm-ups) vs roofline "
        f"{roof.step_time * 1e3:.3f} ms ({roof.bottleneck}: compute "
        f"{roof.t_compute * 1e3:.3f}, memory {roof.t_memory * 1e3:.3f}): "
        f"share of the roofline {roof.step_time * 1e3 / ms:.3f} ok")
    del params, mom, batch
    _free(torch)


def phase_dryrun_decode(torch) -> None:
    """(c) a dense decode step of full-depth qwen2-7b (bf16 weights from
    seed 0) at ``DRY_DECODE_BATCH`` rows over a ``DRY_DECODE_SEQ`` cache:
    FLOPs on meta and on the card (equal, or fail), the step's median wall
    time beside the roofline's memory term (weights and cache read)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as S
    from repro_torch.launch.meta_count import count_step
    from repro_torch.launch.roofline import Roofline, analytic_hbm_bytes
    from repro_torch.models import transformer as M
    cfg = get_config("qwen2-7b")
    cd = cfg.dtype("compute")
    shape = InputShape("decode", DRY_DECODE_SEQ, DRY_DECODE_BATCH, "decode")
    step = S.make_decode_step(cfg, shape)
    pos = DRY_DECODE_SEQ - 1
    spec = M.init_params(torch.Generator().manual_seed(0), cfg,
                         weight_dtype=cd, device=torch.device("meta"))
    spec_cache = S.cache_specs_struct(cfg, shape)
    meta = count_step(step, spec, spec_cache, S.batch_specs(cfg, shape), pos)
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    params = M.init_params(gen, cfg, weight_dtype=cd)
    cache = M.init_cache(cfg, DRY_DECODE_BATCH, DRY_DECODE_SEQ,
                         S.effective_window(cfg, shape), device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (DRY_DECODE_BATCH, 1), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    card = count_step(step, params, cache, batch, pos)
    if card.flops != meta.flops:
        fail(f"the decode step counts {card.flops} FLOPs on the card and "
             f"{meta.flops} on meta tensors")
    walls = []
    for i in range(2 + DRY_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, cache, batch, pos)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls[2:])
    wbytes, cbytes = _tree_bytes(params), _tree_bytes(cache)
    roof = Roofline(flops=float(meta.flops), hbm_bytes=analytic_hbm_bytes(
        cfg, shape, 1, params_bytes_global=wbytes,
        cache_bytes_global=cbytes), collective_bytes=0.0, chips=1)
    log(f"[dryrun:c] qwen2-7b decode step, {cfg.num_layers} layers, batch "
        f"{DRY_DECODE_BATCH}, cache {DRY_DECODE_SEQ}: flops meta "
        f"{meta.flops} card {card.flops}; weights {wbytes} B, cache "
        f"{cbytes} B; wall median {wall:.3f} ms (host clock, synchronized,"
        f" {DRY_ITERS} steps after 2 warm-ups; min {min(walls[2:]):.3f} max "
        f"{max(walls[2:]):.3f}) vs roofline memory term "
        f"{roof.t_memory * 1e3:.3f} ms ({roof.bottleneck}; compute "
        f"{roof.t_compute * 1e3:.4f}) ok")
    del params, cache
    _free(torch)


def phase_dryrun(torch) -> None:
    """Phase 18: (a)-(c). No port kernel runs on this path: the counts
    stay at 0."""
    t0 = time.perf_counter()
    phase_dryrun_smoke()
    counts = _all_counts()
    for k in counts.values():
        k.launches = 0
    phase_dryrun_train(torch)
    phase_dryrun_decode(torch)
    got = {k: f.launches for k, f in counts.items()}
    if any(got.values()):
        fail(f"the dry-run's steps launched port kernels: {got}")
    log(f"[dryrun] phase 18 in {time.perf_counter() - t0:.1f} s: launches "
        f"{got} (this path runs no port kernel)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks and timings")
    ap.add_argument("--spmd-nccl", action="store_true",
                    help="only the multi-device engine's four-rank phase, "
                         "over NCCL with one rank per card (4 cards)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test runs the "
             "port on a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port's package is not beside this script: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 is compared
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_env(torch)
    phase_build()
    if args.spmd_nccl:
        phase_spmd_ranks(torch, "nccl")
        log(f"[done] spmd over NCCL only, {time.perf_counter() - t_start:.1f}"
            " s")
        return
    errs = phase_check(torch)
    errs.update(phase_check_train(torch))
    times = phase_time(torch)
    times.update(phase_time_train(torch))
    phase_ssm_decode(torch)
    if args.kernels_only:
        log(f"[done] kernels only, {time.perf_counter() - t_start:.1f} s")
        return
    launches = phase_slice(torch)
    phase_parity(torch)
    counts, run_ips = phase_train(torch)
    launches.update(counts)
    phase_train_parity(torch)
    for part in (phase_spmd_nccl(torch), phase_spmd_ranks(torch)):
        for name, n in part.items():
            launches[name] += n
    phase_time_buckets(torch)
    _free(torch)
    lm = phase_lm(torch)
    launches["fused_update"] += lm["fused_update"]
    launches["flash"] += lm["flash"]
    _free(torch)
    opt, opt_errs = phase_opt(torch, run_ips)
    for name, n in opt.items():
        launches[name] += n
        errs[name] = max(errs[name], opt_errs[name])
    _free(torch)
    for name, n in phase_families(torch).items():
        launches[name] += n
    _free(torch)
    t0 = time.perf_counter()
    launches["flash"] += phase_whisper(torch)["flash"]
    launches["flash"] += phase_vision(torch)["flash"]
    log(f"[vlm] phase 15 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in phase_replay(torch).items():
        launches[name] += n
    log(f"[replay] phase 16 in {time.perf_counter() - t0:.1f} s")
    tuned, tuned_errs = phase_autotune(torch, run_ips)
    for name, n in tuned.items():
        launches[name] += n
    for name, e in tuned_errs.items():
        errs[name] = max(errs[name], e)
    _free(torch)
    phase_dryrun(torch)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    rows = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/paged_attention/csrc/"
                   "paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/paged_attention.py:112",
         "launches": launches["paged"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:83",
         "launches": launches["flash"]},
        {"name": "fused_update", "route": "cuda",
         "source": "src/repro_torch/kernels/fused_update/csrc/fused_update.cu",
         "replaces": "src/repro/kernels/fused_update/fused_update.py:53",
         "launches": launches["fused_update"]},
        {"name": "lowering_conv", "route": "cuda",
         "source": "src/repro_torch/kernels/lowering_conv/csrc/"
                   "lowering_conv.cu",
         "replaces": "src/repro/kernels/lowering_conv/lowering_conv.py:91",
         "launches": launches["lowering_conv"]},
        {"name": "wgrad", "route": "cuda",
         "source": "src/repro_torch/kernels/lowering_conv/csrc/wgrad.cu",
         "replaces": "src/repro/kernels/lowering_conv/bwd.py:106",
         "launches": launches["wgrad"]},
        {"name": "dgrad", "route": "cuda",
         "source": "src/repro_torch/kernels/lowering_conv/csrc/dgrad.cu",
         "replaces": "src/repro/kernels/lowering_conv/bwd.py:143",
         "launches": launches["dgrad"]},
    ]
    for row in rows:
        t = times[row["name"]]
        row.update(max_abs_err=errs[row["name"]], ms=t["ms"],
                   plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                   bound_by=t["bound_by"], library_ms=t["library_ms"])
        if not all(math.isfinite(row[k]) for k in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms")):
            fail(f"non-finite measurement in {row}")
        if row["launches"] < 1:
            fail(f"{row['name']} was launched no time on the main path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
