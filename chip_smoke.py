#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases, each of which exits non-zero on failure (nothing is caught and
passed over, nothing falls back to the CPU):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: every kernel from its CUDA source in this checkout (in
   parallel, ``-Xptxas -v`` report printed), timed;
3. kernels against their plain PyTorch versions at the serving path's
   shapes, bf16 (``atol = rtol = 2e-2``, and a relative RMS error within
   ``1e-2`` of the output's own RMS, which long-context outputs of small
   magnitude cannot pass on the absolute term) and fp32 (``1e-5``) — they
   differ only in summation order and, in bf16, in where the plain version
   rounds: paged decode at position 0, a page boundary, a full table, a
   wrapped ring, a stale retired row; flash attention causal at 256 (the
   served prefill bucket), 512 and 1024, windowed, ragged, and with per-row
   query offsets;
4. kernel timings (CUDA events around device work only, L2 flushed before
   each launch) beside the plain version, one PyTorch library call
   computing the same function (timed here only; the port never calls
   it), and the card's bound;
5. the slice at full width: ``ContinuousServer`` on qwen2-7b (28 layers,
   d_model 3584, bf16 weights made from a seed) with ``attn_impl="cuda"``
   serves Poisson requests twice — scan prefill, then parallel prefill —
   with the kernels' launch counts zeroed just before each run and
   checked just after against the run's own decode steps and prefills;
   then ``torch.profiler`` over full-width decode steps (device idle share
   and the kernels that take the device time);
6. slice parity: at qwen2-7b widths, 2 layers, fp32, ``attn_impl="cuda"``
   and ``"torch"`` agree within ``1e-4`` on the per-step logits of
   ``paged_decode_step`` and, for the server's parallel prefill, on the
   ``transformer.forward`` logits and on the pages
   ``ContinuousServer._parallel_prefill`` writes.

Then the ``kernels`` JSON line, the ``nvidia-smi`` name / power-limit line,
and last ``{"ok": true, "device": {...}}``. ``--kernels-only`` stops after
phase 4 and prints no final line.
"""
from __future__ import annotations

import argparse
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
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
BF16_REL_RMS = 1e-2            # ~2.5 bf16 ulps of relative error, on average

PAGED = dict(B=8, K=4, G=7, hd=128, page=16, n_pages=64)   # qwen2-7b serving
FLASH = dict(B=8, H=28, K=4, hd=128)
SPIN_CYCLES = 20_000_000       # ~10 ms at the H100's clock: covers any enqueue


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


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    line = smi.stdout.strip().splitlines()[0].strip()
    log(f"[env] nvidia-smi: {line}")
    return line


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    log(f"[build] {len(libs)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs.values()))


def paged_inputs(torch, dtype, pos, *, stale=(), ring=False, seed=0):
    """Pools, a page table (each row its own pages; columns past a linear
    row's live page point at scratch page 0, as the allocator leaves them)
    and positions at the serving path's shapes."""
    B, K, G, hd, page, n = (PAGED[k] for k in
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


def phase_check(torch) -> dict:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    errs = {"paged_attention": 0.0, "flash_attention": 0.0}
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
        ]
        for label, kw, window in cases:
            args = paged_inputs(torch, dtype, **kw)
            got = pa.paged_attention(*args, window=window)
            want = paged_attention_ref(*args, window=window)
            e = compare(torch, f"paged_attention {label} {dn}", got, want, dn)
            if dtype is torch.bfloat16:
                errs["paged_attention"] = max(errs["paged_attention"], e)

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
    return errs


def phase_time(torch) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
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
    log(f"[time] paged_attention bf16 B={B} K={K} G={G} hd={hd} page={page} "
        f"live_tokens={tokens}: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
        f"library_ms={lib:.4f} (SDPA enable_gqa over the {W}-slot gathered "
        f"copy) bound_ms={b_ms:.5f} ({b_by})")
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
    del flush
    torch.cuda.empty_cache()
    return out


def _drive(torch, srv, reqs, mode: str) -> dict:
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
    log(f"[slice:{mode}] decode_steps={steps} prefills={buckets} "
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
    log(f"[slice:{mode}] {len(rep.rids)} reqs {rep.total_tokens} tok in "
        f"{rep.makespan:.3f} s: {rep.throughput:.1f} tok/s "
        f"p50={rep.percentile(50) * 1e3:.1f} ms "
        f"p99={rep.percentile(99) * 1e3:.1f} ms "
        f"decode_step_ms median={statistics.median(step_ms):.2f} "
        f"min={min(step_ms):.2f} max={max(step_ms):.2f} "
        f"occupancy={rep.occupancy_mean:.2f}")
    return {"rep": rep, "paged": n_pa, "flash": n_fa}


def phase_profile(torch, srv, steps: int = 5) -> None:
    """Full-width decode steps (8 active slots at ~200-token contexts):
    wall time per step on the host clock (no profiler), device busy time
    per step (the sum of kernel times under ``torch.profiler``), the
    device's idle share, and the kernels that take the device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
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

    step()                                                # warm
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                  # operator rows repeat their kernels
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        kernels.append((us / steps / 1e3, e.count / steps, e.key))
    busy = sum(k[0] for k in kernels)
    kernels.sort(reverse=True)
    log(f"[profile] full-width decode step, 8 active slots: wall "
        f"{wall_ms:.2f} ms (host clock, no profiler), device busy "
        f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}, "
        f"{sum(k[1] for k in kernels):.0f} kernels a step")
    for ms, n, name in kernels[:8]:
        log(f"[profile]   {ms:7.3f} ms  x{n:<6.0f} {name[:80]}")
    for s in range(S):
        srv.alloc.release(s)


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


def phase_parity(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import (ContinuousServer, PageAllocator,
                                     PagedCacheSpec, init_pages,
                                     paged_decode_step)
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=2,
                              compute_dtype="float32")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
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
    log(f"[parity] qwen2-7b widths, 2 layers, fp32, 6 decode steps: cuda vs "
        f"torch logits max_abs_err={worst:.3e} (tol 1e-4) ok")
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
    log(f"[parity] qwen2-7b widths, 2 layers, fp32, parallel prefill of 8 "
        f"prompts {plens} (bucket 256): cuda vs torch forward logits "
        f"max_abs_err={e_logits:.3e}, written pages max_abs_err="
        f"{e_pages:.3e} (tol 1e-4) ok")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks and timings")
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
    errs = phase_check(torch)
    times = phase_time(torch)
    if args.kernels_only:
        log(f"[done] kernels only, {time.perf_counter() - t_start:.1f} s")
        return
    launches = phase_slice(torch)
    phase_parity(torch)
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
    ]
    for row in rows:
        t = times[row["name"]]
        row.update(max_abs_err=errs[row["name"]], ms=t["ms"],
                   plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                   bound_by=t["bound_by"], library_ms=t["library_ms"])
        if not all(math.isfinite(row[k]) for k in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms")):
            fail(f"non-finite measurement in {row}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
