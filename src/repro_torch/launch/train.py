"""Training launcher: argument parsing in front of the engine
(``repro_torch.engine``) for the paper's CNN workloads, on the card by
default.

The JAX package's ``launch/train.py`` for the CNN archs (lenet, cifarnet,
caffenet; full size or ``--smoke``) with the merged-FC head, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain path and then needs
``--conv-impl lowering`` or ``torch`` and ``--update-impl torch``). The
port's names: ``--conv-impl lowering_cuda|lowering|lowering_autodiff|torch``
(default: the config's, ``lowering_cuda``), ``--update-impl cuda|torch``
(default ``cuda``). LM archs, ``--plan``, ``--replay-trace``, ``--ckpt``,
``--mp`` and ``--exec-mode spmd|reference`` raise ``NotImplementedError``
naming their ROADMAP item.

  python -m repro_torch.launch.train --arch caffenet --batch 256 \\
      --groups 4 --momentum 0.3 --lr 0.01 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch lenet --smoke \\
      --device cpu --conv-impl lowering --update-impl torch --steps 3
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.data.pipeline import DataConfig, SyntheticImages
from repro_torch.device import CONV_IMPLS, UPDATE_IMPLS, check_conv_impl, resolve
from repro_torch.engine import Engine
from repro_torch.models import cnn as C
from repro_torch.optim.sgd import init_momentum

_NOT_PORTED = {
    "plan": "the heterogeneous planner is ROADMAP Queue A item 14",
    "replay_trace": "trace replay is ROADMAP Queue A item 13",
    "ckpt": "checkpointing is ROADMAP Queue A item 9",
    "mp": "the model-parallel mesh axis is ROADMAP Queue A item 8",
}


def _build_workload(args, device):
    """(cfg, params, loss_fn, data_iterable) for a CNN --arch."""
    cfg = C.get_cnn_smoke_config(args.arch) if args.smoke \
        else C.get_cnn_config(args.arch)
    if args.conv_impl:
        cfg = dataclasses.replace(cfg, conv_impl=args.conv_impl)
    check_conv_impl(cfg.conv_impl, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = C.init_params(gen, cfg)
    data = SyntheticImages(DataConfig(
        batch_size=args.batch, image_size=cfg.image_size,
        channels=cfg.in_channels, num_classes=cfg.num_classes,
        seed=args.seed))
    return (cfg, params, lambda p, b: C.loss_fn(p, b, cfg),
            data.batches(args.steps))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lenet",
                    help=f"CNN arch: {', '.join(sorted(C.CNN_CONFIGS))} "
                         "(LM archs are not ported to training yet)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--groups", type=int, default=1,
                    help="compute groups g (paper's execution strategy)")
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--strategy",
                    choices=("sync", "grouped-fused", "grouped-scan"),
                    default="grouped-fused",
                    help="engine strategy (sync is the g=1 reduction)")
    ap.add_argument("--exec-mode", choices=("vmap", "spmd", "reference"),
                    default="vmap",
                    help="step placement: one device ('vmap'); the group "
                         "mesh is not ported yet")
    ap.add_argument("--update-impl", choices=UPDATE_IMPLS, default="cuda",
                    help="leaf path of the fused update: cuda = the kernel, "
                         "torch = the plain version")
    ap.add_argument("--conv-impl", choices=CONV_IMPLS, default="",
                    help="conv path: lowering_cuda = the lowering-conv, "
                         "wgrad and dgrad kernels (config default), "
                         "lowering = their plain twin with the custom "
                         "backward, lowering_autodiff = plain autograd, "
                         "torch = F.conv2d")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain paths only)")
    ap.add_argument("--metrics-out", type=str, default="",
                    help="sink the run's metric stream (step_s, "
                         "data_wait_s, h2d_s, loss) to this JSONL file "
                         "(schema: repro_torch.obs.metrics)")
    # flags of the JAX launcher whose subsystems are not ported yet
    ap.add_argument("--plan", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--replay-trace", default="", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", default="", help=argparse.SUPPRESS)
    ap.add_argument("--mp", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, why in _NOT_PORTED.items():
        val = getattr(args, flag)
        if val and not (flag == "mp" and val == 1):
            raise NotImplementedError(f"--{flag.replace('_', '-')}: {why}")
    if args.arch not in C.CNN_CONFIGS:
        raise NotImplementedError(
            f"--arch {args.arch}: the port trains the CNN archs "
            f"({', '.join(sorted(C.CNN_CONFIGS))}); LM training is ROADMAP "
            "Queue A item 10")
    return _run(args)


def _run(args):
    device = resolve(args.device)
    cfg, params, loss_fn, data = _build_workload(args, device)
    mom = init_momentum(params)
    engine = Engine(loss_fn, strategy=args.strategy, num_groups=args.groups,
                    lr=args.lr, momentum=args.momentum,
                    weight_decay=args.weight_decay, head_filter=C.head_filter,
                    update_impl=args.update_impl, exec_mode=args.exec_mode,
                    device=device)
    n_params = sum(p.numel() for p in T.leaves(params))
    print(f"arch={cfg.name} params={n_params} conv={cfg.conv_impl} "
          f"{engine.describe()}")
    params, mom, losses = engine.run(params, mom, data, steps=args.steps,
                                     log_every=1)
    print(f"final loss {np.mean(losses[-5:]):.4f}")
    summary = engine.telemetry.summary(batch_size=args.batch)
    print(f"telemetry: {summary['median_step_ms']:.1f} ms/step median, "
          f"{summary['examples_per_s']:.0f} examples/s, "
          f"{summary['data_wait_ms']:.1f} ms/step host data wait")
    if args.metrics_out:
        from repro_torch.obs import run_metadata
        run = run_metadata(device=device.type, extra={
            "arch": args.arch, "groups": args.groups, "batch": args.batch,
            "steps": args.steps, "strategy": args.strategy})
        n = engine.telemetry.registry.to_jsonl(args.metrics_out, run)
        print(f"metrics -> {args.metrics_out} ({n} records)")
    return losses


if __name__ == "__main__":
    main()
