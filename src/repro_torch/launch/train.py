"""Training launcher: argument parsing in front of the engine
(``repro_torch.engine``), on the card by default.

The JAX package's ``launch/train.py`` for the token LMs of the dense,
MoE, SSM and hybrid families (``--arch qwen2-7b``, the default,
``qwen2-moe-a2.7b``, ``mamba2-2.7b``, ``recurrentgemma-2b`` and the other
configs of those families; ``--seq`` tokens a sequence from the
``SyntheticLM`` stream, ``lm_loss`` with the MoE load-balance term, no
merged-FC head) and for the paper's CNN archs (lenet, cifarnet,
caffenet, with the merged-FC head), full size or ``--smoke``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain path and then needs
``--update-impl torch``, and for a CNN ``--conv-impl lowering`` or
``torch``). The port's names: ``--conv-impl
lowering_cuda|lowering|lowering_autodiff|torch`` (CNN archs; default: the
config's, ``lowering_cuda``), ``--update-impl cuda|torch`` (default
``cuda``). As in the JAX launcher, ``encdec`` and ``vlm`` archs exit (their
modality-stub variants are examples).

Trace replay (``--replay-trace trace.npz``, a saved ``EventTrace``):
instead of round-robin rounds, the engine's ``trace-replay`` strategy
executes one stale momentum-SGD commit per trace event on one batch of
``--batch`` examples each (the trace truncated to ``--steps`` commits),
through ``--replay-impl`` (``scan``, ``python`` or ``fused``) and an
optional ``--replay-depth`` cap on the parameter-history ring; it excludes
``--plan``, as in the JAX launcher.

Heterogeneous planning (``--cluster-spec ... --plan``, as in the JAX
launcher) picks g, the device->group packing and throughput-proportional
batch shares over the named devices (``repro_torch.cluster``), prints the
plan, and trains with the planned g, each group's gradient weighted by
its share and each group's batch its share wrap-filled to the largest.
The plan's model-parallel width falls back to 1 when the process group is
smaller than g·mp.

Across ranks (``--exec-mode spmd``, or ``auto`` with a world of >= g
ranks), run under ``torchrun``: every rank makes the same global batches
from ``--seed`` and trains on its own shard; ``--dist-backend`` is
``nccl`` on ``cuda`` and ``gloo`` on ``cpu`` unless given, and is always
the one asked for. Only rank 0 prints and writes files.

A CNN on the kernels (``conv_impl="lowering_cuda"``, the JAX
``lowering_interpret``) has its conv tiles autotuned before the engine is
built, at the per-group batch (``models.cnn.autotune_conv_tiles``), and
the per-layer choice printed; under ``torchrun`` rank 0 probes and every
rank runs its choice (wgrad's split sets the order of its sums, and the
ranks must agree bitwise with the single-process twin). ``--metrics-out``
writes the metric stream (JSONL) and ``--trace-out`` a Chrome trace of the
run's spans (autotune probes included), its metrics and, on replay, the
replayed ``EventTrace``.

  python -m repro_torch.launch.train --arch qwen2-7b --smoke --groups 4 \\
      --momentum 0.3 --lr 0.05 --steps 60
  python -m repro_torch.launch.train --arch caffenet --batch 256 \\
      --groups 4 --momentum 0.3 --lr 0.01 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --smoke --device cpu --update-impl torch --groups 2 --seq 32 \\
      --batch 8 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      recurrentgemma-2b --smoke --device cpu --update-impl torch
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch lenet --smoke --device cpu --conv-impl lowering \\
      --update-impl torch --groups 2 --batch 16 --exec-mode spmd --steps 3
  python -m repro_torch.launch.train --arch caffenet --batch 256 \\
      --cluster-spec 1xgpu-g2.2xlarge,2xcpu-c4.4xlarge --plan --steps 5
  python -m repro_torch.launch.train --arch caffenet --batch 64 \\
      --steps 32 --replay-trace trace.npz
  python -m repro_torch.launch.train --arch caffenet --batch 256 \\
      --groups 4 --steps 5 --trace-out run.trace.json
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import tree as T
from repro_torch.data.pipeline import DataConfig, SyntheticImages, SyntheticLM
from repro_torch.device import CONV_IMPLS, UPDATE_IMPLS, check_conv_impl, resolve
from repro_torch.engine import Engine
from repro_torch.engine.engine import EXEC_MODES
from repro_torch.kernels.lowering_conv import autotune
from repro_torch.models import cnn as C
from repro_torch.models import transformer as M
from repro_torch.optim.sgd import init_momentum

def _build_workload(args, device):
    """(cfg, params, loss_fn, data_iterable, head_filter) per --arch."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.arch in C.CNN_CONFIGS:
        cfg = C.get_cnn_smoke_config(args.arch) if args.smoke \
            else C.get_cnn_config(args.arch)
        if args.conv_impl:
            cfg = dataclasses.replace(cfg, conv_impl=args.conv_impl)
        check_conv_impl(cfg.conv_impl, device)
        data = SyntheticImages(DataConfig(
            batch_size=args.batch, image_size=cfg.image_size,
            channels=cfg.in_channels, num_classes=cfg.num_classes,
            seed=args.seed))
        return (cfg, C.init_params(gen, cfg),
                lambda p, b: C.loss_fn(p, b, cfg), data.batches(args.steps),
                C.head_filter)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.arch_type in ("encdec", "vlm"):
        raise SystemExit("train.py drives token-LM and CNN archs; see "
                         "examples/ for the modality-stub variants")
    M.require_ported(cfg)
    if args.conv_impl:
        raise ValueError(f"--conv-impl applies to CNN archs "
                         f"({', '.join(sorted(C.CNN_CONFIGS))}), not "
                         f"{args.arch}")
    data = SyntheticLM(DataConfig(batch_size=args.batch, seq_len=args.seq,
                                  vocab_size=cfg.vocab_size, seed=args.seed))
    return (cfg, M.init_params(gen, cfg), lambda p, b: M.lm_loss(p, b, cfg),
            data.batches(args.steps), None)


def _plan(args, params, cfg, say=print):
    """Heterogeneous plan: g, device->group packing, batch shares (the JAX
    launcher's cost model and (g, mp) candidates)."""
    from repro_torch import cluster
    devices = cluster.parse_cluster_spec(args.cluster_spec)
    n_params = sum(p.numel() for p in T.leaves(params))
    tokens = args.seq if hasattr(cfg, "vocab_size") else 1
    # rough roofline: ~6*P FLOPs per token fwd+bwd, one param sweep of
    # memory traffic per example, fp32 gradient payload; fp32 params +
    # fp32 momentum resident per model replica
    cost = cluster.WorkloadCost(flops_per_example=6.0 * n_params * tokens,
                                bytes_per_example=4.0 * n_params,
                                grad_bytes=4.0 * n_params,
                                state_bytes=8.0 * n_params)
    # merged-FC phase ~ the head matmul on the full batch on the fastest
    # device (unembed for LMs, the FC stack for CNNs)
    if hasattr(cfg, "vocab_size"):
        head_flops = 6.0 * cfg.d_model * cfg.vocab_size * args.seq
    else:
        head_flops = 6.0 * sum(int(np.prod(p["w"].shape))
                               for p in params["fc"])
    t_fc = args.batch * head_flops / max(d.peak_flops for d in devices)
    # 2-D (g, mp) search: powers of two up to the cluster's size;
    # infeasible points (memory, group width) are skipped by the planner
    n = len(devices)
    mp_candidates = [m for m in (1, 2, 4, 8, 16) if m <= n]
    plan = cluster.best_allocation(devices, global_batch=args.batch,
                                   t_fc=t_fc, cost=cost,
                                   mp_candidates=mp_candidates)
    say(plan.describe())
    return plan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch",
                    choices=[*list_archs(), *sorted(C.CNN_CONFIGS)],
                    default="qwen2-7b",
                    help="token LM (dense, moe, ssm, hybrid) or CNN arch")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens a sequence (LM archs)")
    ap.add_argument("--groups", type=int, default=1,
                    help="compute groups g (paper's execution strategy)")
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--strategy",
                    choices=("sync", "grouped-fused", "grouped-scan"),
                    default="grouped-fused",
                    help="engine strategy (sync is the g=1 reduction)")
    ap.add_argument("--mp", type=int, default=1,
                    help="model-parallel ranks per worker: params and "
                         "momentum stored as shards over the mesh's 'mp' "
                         "axis; the world becomes groups*k*mp ranks")
    ap.add_argument("--exec-mode", choices=EXEC_MODES, default="auto",
                    help="step placement: the group mesh over the "
                         "torchrun world when it has >= g ranks (auto), "
                         "the mesh forced (spmd), its bitwise "
                         "single-process twin (reference), or one device "
                         "(vmap)")
    ap.add_argument("--bucket-bytes", type=int, default=None,
                    help="slab size target of the SPMD step's overlapped "
                         "bucketed gradient exchange (0 = whole-tree "
                         "gather; default engine.spmd.DEFAULT_BUCKET_BYTES)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default="",
                    help="process-group backend under torchrun (default: "
                         "nccl on cuda, gloo on cpu)")
    ap.add_argument("--ckpt", type=str, default="",
                    help="directory to checkpoint params and momentum to "
                         "after the last step (npz, the JAX package's "
                         "names)")
    ap.add_argument("--update-impl", choices=UPDATE_IMPLS, default="cuda",
                    help="leaf path of the fused update: cuda = the kernel, "
                         "torch = the plain version")
    ap.add_argument("--conv-impl", choices=CONV_IMPLS, default="",
                    help="CNN conv path (CNN archs only): lowering_cuda = "
                         "the lowering-conv, wgrad and dgrad kernels "
                         "(config default), lowering = their plain twin "
                         "with the custom backward, lowering_autodiff = "
                         "plain autograd, torch = F.conv2d")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain paths only)")
    ap.add_argument("--metrics-out", type=str, default="",
                    help="sink the run's metric stream (step_s, "
                         "data_wait_s, h2d_s, loss) to this JSONL file "
                         "(schema: repro_torch.obs.metrics)")
    ap.add_argument("--trace-out", type=str, default="",
                    help="export a Chrome trace-event JSON of the run's "
                         "spans + metrics to this file (open in Perfetto)")
    ap.add_argument("--cluster-spec", type=str, default="",
                    help="heterogeneous cluster, e.g. "
                         "'8xgpu-g2.2xlarge,8xcpu-c4.4xlarge' (device "
                         "names: repro_torch.cluster.list_devices())")
    ap.add_argument("--plan", action="store_true",
                    help="plan g / device packing / batch shares over "
                         "--cluster-spec and train share-weighted "
                         "(overrides --groups and --mp)")
    ap.add_argument("--replay-trace", type=str, default="",
                    help="replay a recorded event trace (.npz EventTrace): "
                         "one per-commit stale update per trace commit "
                         "instead of round-robin rounds (truncated to "
                         "--steps commits)")
    ap.add_argument("--replay-impl", choices=("scan", "python", "fused"),
                    default="scan")
    ap.add_argument("--replay-depth", type=int, default=0,
                    help="cap the replay parameter-history ring "
                         "(0 = full max-staleness depth)")
    args = ap.parse_args(argv)
    if args.plan and not args.cluster_spec:
        ap.error("--plan requires --cluster-spec")
    if args.plan and args.replay_trace:
        ap.error("--plan and --replay-trace are mutually exclusive "
                 "(a replay executes a recorded schedule; there is "
                 "nothing for the planner to allocate)")
    # a recording span tracer for the whole run (workload build, autotune
    # probes, engine loop) iff a trace export was requested; otherwise
    # every span stays the shared no-op
    from repro_torch.obs import spans
    with spans.maybe_traced(bool(args.trace_out)):
        return _run(args)


def _init_dist(args, device):
    """Join the torchrun world (``WORLD_SIZE`` in the environment) unless a
    process group is already up. -> (device of this rank, whether this
    call created the group)."""
    import torch.distributed as dist
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return device, False
    backend = args.dist_backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://")
    return device, True


def _run(args):
    import torch.distributed as dist
    device, owned = _init_dist(args, resolve(args.device))
    try:
        return _train(args, device)
    finally:
        if owned:
            dist.destroy_process_group()


def _autotune(args, cfg, device, say) -> None:
    """Probe and cache the conv tiles of every layer at the per-group batch
    before the engine is built (the cache key leaves the batch out, so a
    rank's shard finds it too). Under torchrun rank 0 probes and every
    rank caches its choice."""
    import torch.distributed as dist
    spread = dist.is_initialized() and dist.get_world_size() > 1
    batch = max(1, args.batch // args.groups)
    tiles = [None]
    if not spread or dist.get_rank() == 0:
        tiles[0] = C.autotune_conv_tiles(cfg, batch, device=device)
    if spread:
        dist.broadcast_object_list(tiles, src=0)
        for i, (xs, ws, s) in enumerate(C.conv_layer_shapes(cfg, batch)):
            autotune.put_tiles(xs, ws, s, tiles[0][i], device=device)
    say("autotuned conv tiles: " + ", ".join(
        f"layer{i}(fwd={t.fwd_bn},wgrad={t.wgrad_bn}x{t.wgrad_blocks},"
        f"dgrad={t.dgrad_bn})" for i, t in sorted(tiles[0].items())))


def _export_obs(args, engine, groups: int, event_trace=None) -> None:
    """Sink the run's metric stream / Chrome trace when requested (rank 0
    only)."""
    from repro_torch.engine.engine import rank_and_world
    if not (args.metrics_out or args.trace_out) or rank_and_world()[0]:
        return
    from repro_torch.obs import export_chrome_trace, run_metadata
    if args.metrics_out:
        strategy = "trace-replay" if args.replay_trace else args.strategy
        run = run_metadata(device=engine.device.type, extra={
            "arch": args.arch, "groups": groups, "batch": args.batch,
            "steps": args.steps, "strategy": strategy})
        n = engine.telemetry.registry.to_jsonl(args.metrics_out, run)
        print(f"metrics -> {args.metrics_out} ({n} records)")
    if args.trace_out:
        tracer = engine.tracer if engine.tracer.enabled else None
        n = export_chrome_trace(args.trace_out, tracer=tracer,
                                metrics=engine.telemetry.registry,
                                event_trace=event_trace)
        print(f"chrome trace -> {args.trace_out} ({n} events; open at "
              "https://ui.perfetto.dev)")


def _train(args, device):
    from repro_torch.engine.engine import rank_and_world
    rank = rank_and_world()[0]

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    cfg, params, loss_fn, data, head_filter = _build_workload(args, device)
    if args.arch in C.CNN_CONFIGS and cfg.conv_impl == "lowering_cuda":
        _autotune(args, cfg, device, say)
    mom = init_momentum(params)
    if args.replay_trace:
        return _replay(args, cfg, params, mom, loss_fn, data, device, say)
    groups, group_weights, micro_sizes, mp = args.groups, None, None, args.mp
    if args.plan:
        plan = _plan(args, params, cfg, say)
        groups, group_weights = plan.g, plan.weights
        micro_sizes = plan.allocation.microbatches
        mp = plan.mp
        # the plan's mp is sized for the --cluster-spec devices; when this
        # run has a smaller process group (one process: world 1),
        # mp-sharded storage has no mesh to live on — store unsharded and
        # keep the rest of the plan
        world = rank_and_world()[1]
        if args.exec_mode == "auto" and mp > 1 and world < groups * mp:
            say(f"plan chose mp={mp} for the cluster; local pool has "
                f"{world} device(s) < g*mp={groups * mp} — storing params "
                "unsharded here (mp=1)")
            mp = 1
    engine = Engine(loss_fn, strategy=args.strategy, num_groups=groups,
                    lr=args.lr, momentum=args.momentum,
                    weight_decay=args.weight_decay,
                    group_weights=group_weights, micro_sizes=micro_sizes,
                    head_filter=head_filter,
                    update_impl=args.update_impl, exec_mode=args.exec_mode,
                    mp=mp, device=device,
                    **({"bucket_bytes": args.bucket_bytes}
                       if args.bucket_bytes is not None else {}),
                    checkpoint_dir=args.ckpt,
                    checkpoint_every=args.steps if args.ckpt else 0)
    n_params = sum(p.numel() for p in T.leaves(params))
    what = (f"conv={cfg.conv_impl}" if args.arch in C.CNN_CONFIGS
            else f"seq={args.seq}")
    say(f"arch={cfg.name} params={n_params} {what} "
        f"{engine.describe(args.batch // groups)}"
        + (" (planned)" if args.plan else ""))
    params, mom, losses = engine.run(params, mom, data, steps=args.steps,
                                     log_every=1, log=say)
    say(f"final loss {np.mean(losses[-5:]):.4f}")
    summary = engine.telemetry.summary(batch_size=args.batch)
    say(f"telemetry: {summary['median_step_ms']:.1f} ms/step median, "
        f"{summary['examples_per_s']:.0f} examples/s, "
        f"{summary['data_wait_ms']:.1f} ms/step host data wait")
    _export_obs(args, engine, groups)
    if args.ckpt:
        say(f"checkpointed to {args.ckpt}")
    return losses


def _replay(args, cfg, params, mom, loss_fn, data, device, say):
    """``--replay-trace``: the engine's ``trace-replay`` strategy along the
    saved trace, one batch a commit."""
    from repro_torch.exec.trace import EventTrace
    trace = EventTrace.load(args.replay_trace)
    engine = Engine(loss_fn, strategy="trace-replay", trace=trace,
                    lr=args.lr, momentum=args.momentum,
                    weight_decay=args.weight_decay,
                    update_impl=args.update_impl,
                    replay_impl=args.replay_impl,
                    replay_depth=args.replay_depth or None, device=device)
    t = trace.truncate(args.steps)
    if len(t) == 0:
        raise SystemExit(f"{args.replay_trace} has no commits to replay "
                         f"(after truncation to --steps {args.steps})")
    say(f"arch={cfg.name} replaying {args.replay_trace}: {len(t)} commits, "
        f"g={trace.num_groups}, mean staleness "
        f"{float(t.staleness.mean()):.2f}, max {t.max_staleness}")
    _, _, losses = engine.run(params, mom, data, steps=args.steps,
                              log_every=10, log=say)
    say(f"final loss {np.mean(losses[-5:]):.4f} (impl={args.replay_impl})")
    _export_obs(args, engine, trace.num_groups, event_trace=t)
    return losses


if __name__ == "__main__":
    main()
