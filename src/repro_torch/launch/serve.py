"""Serving launcher: static batched generation or trace-driven continuous
batching (``repro_torch.serving``), on the card by default.

The JAX package's ``launch/serve.py`` with the same flags, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path) and
the port's ``--attn-impl`` names (``torch`` / ``cuda`` / ``cuda_gather``,
default ``cuda`` on the card and ``torch`` on the CPU). Every family
serves statically; continuous batching pages a KV cache and so takes
dense and MoE archs only (an SSM, hybrid, vlm or encdec arch raises
``ValueError``, as in JAX). The vlm and encdec archs serve, as in JAX,
with their image / encoder K/V caches left at zero.

- ``--mode static``: one batch, prefill filling the whole KV cache, then
  a per-token decode loop; per-phase timings go through the metric
  registry on the port's one monotonic clock.
- ``--mode continuous``: a Poisson request trace (``--rate``/``--requests``,
  or ``--arrival-trace`` to replay a saved ``EventTrace``) served by the
  ``ContinuousServer`` — slot-recycled paged KV cache, bucketed prefill —
  reported as tok/s + p50/p99 latency + p50/p90 time to first token +
  goodput at ``--slo-ms``, with the static baseline on the same trace for
  comparison.

  python -m repro_torch.launch.serve --arch qwen2-7b --mode continuous
  python -m repro_torch.launch.serve --arch mamba2-2.7b
  python -m repro_torch.launch.serve --arch whisper-base
  python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --mode continuous
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --smoke --mode continuous --device cpu --requests 4
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.device import ATTN_IMPLS, resolve
from repro_torch.engine.timing import monotonic, synchronize
from repro_torch.exec.trace import EventTrace
from repro_torch.models import transformer as T
from repro_torch.obs import spans
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.serving import (ContinuousServer, poisson_trace,
                                 sample_requests, static_serve_trace)
from repro_torch.serving.engine import random_params


def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          registry: MetricRegistry | None = None, device="cuda"):
    """Static-batch generation: prefill fills the whole KV cache, then a
    per-token decode loop for the generated suffix. Phase timings land in
    ``registry`` (series ``serve.prefill_s`` / ``serve.decode_s``).
    Returns (gen_tokens (B, gen), prefill_seconds, decode_seconds)."""
    dev = resolve(device)
    reg = registry if registry is not None else MetricRegistry()
    params = random_params(cfg, seed, dev)
    rng = np.random.default_rng(seed)
    prompts = torch.tensor(rng.integers(cfg.vocab_size,
                                        size=(batch, prompt_len)),
                           dtype=torch.int32, device=dev)
    total = prompt_len + gen
    cache = T.init_cache(cfg, batch, total, device=dev)

    t0 = monotonic()
    with spans.span("serve.prefill", batch=batch, prompt_len=prompt_len):
        logits, cache = T.prefill(params, cache, prompts, cfg)
        synchronize()
    t_prefill = monotonic() - t0
    reg.series("serve.prefill_s").append(t_prefill)

    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    outs = [tok]
    t0 = monotonic()
    with spans.span("serve.decode", batch=batch, gen=gen):
        for t in range(prompt_len, total - 1):
            logits, cache = T.decode_step(params, cache, tok, t, cfg)
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
            tok = tok.to(torch.int32)
            outs.append(tok)
        synchronize()
    t_decode = monotonic() - t0
    reg.series("serve.decode_s").append(t_decode)
    return torch.cat(outs, dim=1).cpu(), t_prefill, t_decode


def _run_continuous(cfg, args, registry: MetricRegistry, device):
    if args.arrival_trace:
        trace = EventTrace.load(args.arrival_trace)
    else:
        trace = poisson_trace(args.rate, args.requests, seed=args.seed)
    pmax = max(args.prompt_len, 8)
    reqs = sample_requests(trace, cfg, prompt_range=(max(4, pmax // 4), pmax),
                           gen_range=(max(2, args.gen // 4), args.gen),
                           seed=args.seed)
    max_seq = -(-(pmax + args.gen) // args.page_size) * args.page_size
    params = random_params(cfg, args.seed, device)
    srv = ContinuousServer(cfg, params, slots=args.batch,
                           page_size=args.page_size, max_seq=max_seq,
                           attn_impl=args.attn_impl,
                           gather_mode=args.gather_mode, registry=registry,
                           seed=args.seed, device=device)
    for note in registry.notes:           # e.g. cuda_gather ring fallback
        print(f"note: {note}")
    srv.warmup([pmax])
    rep = srv.run(reqs)
    base = static_serve_trace(cfg, reqs, batch=args.batch, params=params,
                              device=device)
    slo = args.slo_ms / 1e3
    ttft = np.percentile(rep.ttfts, [50, 90]) * 1e3
    print(f"arch={cfg.name} continuous: {len(rep.rids)} reqs "
          f"{rep.total_tokens} tok in {rep.makespan:.2f}s "
          f"({rep.throughput:.0f} tok/s) p50={rep.percentile(50) * 1e3:.0f}ms "
          f"p99={rep.percentile(99) * 1e3:.0f}ms "
          f"ttft p50={ttft[0]:.0f}ms p90={ttft[1]:.0f}ms "
          f"goodput@{args.slo_ms:.0f}ms={rep.goodput(slo):.0f} tok/s "
          f"occ={rep.occupancy_mean:.2f}/{args.batch}")
    print(f"arch={cfg.name} static    : {base.makespan:.2f}s "
          f"({base.throughput:.0f} tok/s) "
          f"p50={base.percentile(50) * 1e3:.0f}ms "
          f"p99={base.percentile(99) * 1e3:.0f}ms "
          f"goodput@{args.slo_ms:.0f}ms={base.goodput(slo):.0f} tok/s")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", choices=("static", "continuous"),
                    default="static")
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch size / continuous decode slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="continuous: Poisson arrival rate, req/s")
    ap.add_argument("--requests", type=int, default=16,
                    help="continuous: number of requests")
    ap.add_argument("--arrival-trace", type=str, default="",
                    help="continuous: replay a saved EventTrace .npz "
                         "instead of drawing Poisson arrivals")
    ap.add_argument("--slo-ms", type=float, default=500.0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--attn-impl", choices=ATTN_IMPLS, default=None,
                    help="continuous decode attention: 'cuda' = in-kernel "
                         "paged walk (default on the card), 'torch' = "
                         "masked bucketed gather (default on the CPU), "
                         "'cuda_gather' = flash over a gathered copy "
                         "(falls back to torch under sliding windows, "
                         "loudly)")
    ap.add_argument("--gather-mode", choices=("bucket", "full"),
                    default="bucket",
                    help="torch/cuda_gather decode: narrow the dense gather "
                         "to the batch's live page bucket, or pin the "
                         "full-capacity bitwise baseline")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--metrics-out", type=str, default="",
                    help="write the obs metric stream (JSONL) here")
    ap.add_argument("--trace-out", type=str, default="",
                    help="write a Perfetto-viewable Chrome trace here")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    if args.attn_impl is None:
        args.attn_impl = "cuda" if device.type == "cuda" else "torch"
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    registry = MetricRegistry()

    with spans.maybe_traced(bool(args.trace_out)) as tracer:
        if args.mode == "continuous":
            out = _run_continuous(cfg, args, registry, device)
            toks = out.tokens[int(out.rids[0])]
        else:
            toks, t_prefill, t_decode = serve(cfg, batch=args.batch,
                                              prompt_len=args.prompt_len,
                                              gen=args.gen, seed=args.seed,
                                              registry=registry,
                                              device=device)
            prefill_tps = args.batch * args.prompt_len / t_prefill
            decode_steps = args.gen - 1   # first generated token: prefill
            if decode_steps > 0:
                decode_msg = (
                    f"decode {decode_steps} steps in {t_decode:.2f}s "
                    f"({args.batch * decode_steps / t_decode:.0f} tok/s)")
            else:
                decode_msg = "decode skipped (all tokens from prefill)"
            print(f"arch={cfg.name} generated {tuple(toks.shape)}: "
                  f"prefill {args.prompt_len} tok in {t_prefill:.2f}s "
                  f"({prefill_tps:.0f} tok/s), " + decode_msg)

    if args.metrics_out:
        from repro_torch.obs import run_metadata
        run = run_metadata(str(device), extra={
            "arch": args.arch, "mode": args.mode, "batch": args.batch,
            "gen": args.gen})
        n = registry.to_jsonl(args.metrics_out, run)
        print(f"metrics -> {args.metrics_out} ({n} records)")
    if args.trace_out:
        from repro_torch.obs import export_chrome_trace
        n = export_chrome_trace(args.trace_out,
                                tracer=tracer if tracer.enabled else None,
                                metrics=registry)
        print(f"chrome trace -> {args.trace_out} ({n} events; open at "
              "https://ui.perfetto.dev)")
    toks = np.asarray(toks)
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise RuntimeError("generated token ids out of vocabulary range")
    return toks


if __name__ == "__main__":
    main()
