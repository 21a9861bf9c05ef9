"""Dry-run on meta tensors (the JAX package's ``launch/dryrun.py``): every
(architecture x input shape) at full size on a ("group", "data", "mp")
layout of H100s, reckoned without allocating anything on any device.

The JAX lane lowers and compiles each step over ``ShapeDtypeStruct``
stand-ins and reads XLA's memory analysis and the partitioned HLO. The
port has no compiler to ask, so it runs each step on
``torch.device("meta")`` and counts what the step does:

- per-rank state: the params (and, for training, the momentum) under the
  engine's sharding rules (``sharding.rules.engine_param_specs``). The
  port's multi-device engine (``engine.spmd``) shards storage over "mp"
  only and replicates it over "group" and "data", so the per-rank bytes
  are divided by mp, never by data·mp (the JAX lane's FSDP divisor);
- the step's FLOPs and peak live bytes (``launch.meta_count.count_step``)
  on the rank's own batch: ``global_batch / (groups·data)``, rounded up;
  training counts up to two microbatches of ``launch.steps.
  make_train_step`` and scales the FLOPs to ``grad_accum`` of them, as
  the HLO walk multiplies a loop body by its trip count;
- the exchange of one engine round (``engine.spmd.exchange_bytes``); an
  inference step has only the gathers of the mp-sharded params;
- the three-term roofline (``launch.roofline``) at the H100's data-sheet
  rates: the counted FLOPs, ``analytic_hbm_bytes`` of the rank (its own
  batch, the full params it computes with) and the exchange over NVLink.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --host-smoke
Results: build/dryrun_torch/<arch>__<shape>__<g>x<data>x<mp>.json

``--host-smoke`` is the regression lane for the big configs: the full
train step of ``HOST_SMOKE_ARCHS`` on a (1, 4, 2) layout, failing when no
param leaf shards over mp, when the per-rank argument bytes pass the
sharded-state bound, when the exchange vanishes, or when the step counts
no FLOPs.

The JAX flags ``--multi-pod``, ``--both-meshes``, ``--seqpar`` and
``--wstat`` select GSPMD meshes and activation shardings that the port's
engine does not have; they are not offered.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import InputShape, TrainConfig
from repro_torch.core import tree as T
from repro_torch.engine.spmd import exchange_bytes
from repro_torch.launch import steps as ST
from repro_torch.launch.meta_count import count_step
from repro_torch.launch.params_util import (active_param_count, param_bytes,
                                            param_count)
from repro_torch.launch.roofline import Roofline, analytic_hbm_bytes
from repro_torch.sharding import rules as SH

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

#: an H100's device memory, the data sheet's 80 GB
CARD_BYTES = 80e9

#: what ``memory.argument_bytes`` divides by, stated in every result
STATE_SHARDING = ("mp only: the engine stores params and momentum sharded "
                  "over 'mp' and replicated over 'group' and 'data' "
                  "(sharding.rules.engine_param_specs)")

# grad-accum (microbatching) for train_4k, tuned so remat'd activations fit
# HBM; inference shapes never accumulate.
GRAD_ACCUM = {
    "llama3-405b": 16,
    "llama-3.2-vision-90b": 16,
    "grok-1-314b": 16,
    "deepseek-coder-33b": 8,
    "qwen2-7b": 8,
    "phi4-mini-3.8b": 8,
    "qwen2-moe-a2.7b": 8,
    "mamba2-2.7b": 8,
    "recurrentgemma-2b": 8,
    "whisper-base": 8,   # 51 GiB/chip of fp32 logit temporaries at accum=1
}

# Big configs exercised by the host-smoke lane (dense 405B-class, MoE,
# SSM — one per memory-model family).
HOST_SMOKE_ARCHS = ("llama3-405b", "qwen2-moe-a2.7b", "mamba2-2.7b")


def _tokens_per_step(shape) -> float:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: 1 token per sequence


def _tree_bytes(tree) -> int:
    return sum(math.prod(x.shape) * x.element_size() for x in T.leaves(tree))


def _layout(groups: int, data: int, mp: int) -> dict:
    return {"group": groups, "data": data, "mp": mp}


def rank_state(pspecs, cfg, layout: dict, *, train: bool) -> dict:
    """Per-rank storage of ``pspecs`` under ``engine_param_specs`` on
    ``layout``: the bytes of the rank's param shards (and momentum shards
    when ``train``), the mp-sharded and total leaf counts, and the bytes
    the rank gathers to compute with the full leaves."""
    specs = T.leaves(SH.engine_param_specs(pspecs, layout))
    mp = layout["mp"]
    mom_size = cfg.dtype("mom").itemsize
    state = gathered = sharded = 0
    for leaf, spec in zip(T.leaves(pspecs), specs):
        n = math.prod(leaf.shape)
        split = mp if SH.spec_mp_dim(spec, "mp") is not None else 1
        sharded += split > 1
        state += n // split * (leaf.element_size()
                               + (mom_size if train else 0))
        gathered += (n - n // split) * leaf.element_size()
    return {"state_bytes": state, "mp_leaves": sharded,
            "leaves": len(specs), "gathered_bytes": gathered}


def _count(cfg, shape: InputShape, accum: int, pspecs):
    """``count_step`` of ``shape``'s step on meta inputs. Training runs
    ``min(accum, 2)`` microbatches of ``global_batch // accum`` (two show
    the accumulator's bytes) and scales the FLOPs to ``accum``. -> (the
    count, FLOPs of the whole step, the batch's bytes, the cache's)."""
    meta = torch.device("meta")
    if shape.kind == "train":
        if shape.global_batch % accum:
            raise ValueError(f"rank batch {shape.global_batch} not "
                             f"divisible by grad_accum {accum}")
        micro = min(accum, 2)
        run = dataclasses.replace(
            shape, global_batch=shape.global_batch // accum * micro)
        batch = ST.batch_specs(cfg, run, grad_accum=micro)
        mom = T.tree_map(lambda x: torch.empty(
            x.shape, dtype=cfg.dtype("mom"), device=meta), pspecs)
        step = ST.make_train_step(cfg, TrainConfig(grad_accum=micro), run)
        c = count_step(step, pspecs, mom, batch)
        return c, c.flops * accum // micro, _tree_bytes(batch), 0
    batch = ST.batch_specs(cfg, shape)
    if shape.kind == "prefill":
        c = count_step(ST.make_prefill_step(cfg, shape), pspecs, batch)
        return c, c.flops, _tree_bytes(batch), 0
    cache = ST.cache_specs_struct(cfg, shape)
    c = count_step(ST.make_decode_step(cfg, shape), pspecs, cache, batch,
                   shape.seq_len - 1)
    return c, c.flops, _tree_bytes(batch), _tree_bytes(cache)


def _exchange(pspecs, layout: dict, train: bool, mp_leaves: int) -> dict:
    ex = exchange_bytes(pspecs, layout)
    if train:
        return {"sent": ex.sent, "received": ex.received,
                "gathers": ex.gathers, "by_axis": ex.by_axis}
    # an inference step gathers only the mp shards of its params
    mp = ex.by_axis["mp"]
    return {"sent": mp, "received": mp, "gathers": mp_leaves,
            "by_axis": {"mp": mp}}


def _mesh_name(layout: dict) -> str:
    return f"{layout['group']}x{layout['data']}x{layout['mp']}"


def reckon_one(arch: str, shape_name: str, *, groups: int = 1, data: int = 4,
               mp: int = 2, accum_override: int = None, tag: str = "",
               verbose: bool = True) -> dict:
    """Reckon ``arch`` x ``shape_name`` on a (groups, data, mp) layout:
    the JAX ``lower_one`` result's keys where they have a meaning here.
    ``memory.argument_bytes``: the rank's state (``rank_state``) and
    inputs (its batch, and for decode its cache); ``memory.temp_bytes``:
    the step's peak live bytes beyond them; ``memory.gathered_bytes``: the
    full leaves gathered over mp; ``memory.peak_per_chip_est``: the three
    together."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    layout = _layout(groups, data, mp)
    chips = groups * data * mp
    if not ST.supports_shape(cfg, shape):
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_name(layout), "status": "skipped",
                "reason": "encdec has no 500k-token decode regime "
                          "(launch.steps.supports_shape)"}
    train = shape.kind == "train"
    accum = GRAD_ACCUM.get(arch, 1) if train else 1
    if accum_override is not None and train:
        accum = accum_override
    rank = dataclasses.replace(
        shape, global_batch=-(-shape.global_batch // (groups * data)))
    t0 = time.time()
    pspecs = ST.params_specs(cfg)
    state = rank_state(pspecs, cfg, layout, train=train)
    count, flops, batch_bytes, cache_bytes = _count(cfg, rank, accum,
                                                    pspecs)
    coll = _exchange(pspecs, layout, train, state["mp_leaves"])
    t_reckon = time.time() - t0

    n_total = param_count(pspecs)
    n_active = active_param_count(pspecs, cfg)
    pbytes = param_bytes(pspecs)
    hbm = analytic_hbm_bytes(cfg, rank, 1, grad_accum=accum,
                             params_bytes_global=pbytes,
                             cache_bytes_global=cache_bytes)
    roof = Roofline(flops=float(flops), hbm_bytes=float(hbm),
                    collective_bytes=float(coll["received"]), chips=chips)
    # 6ND for training (fwd+bwd), 2ND for inference (fwd only)
    model_flops = (6.0 if train else 2.0) * n_active * \
        _tokens_per_step(shape)
    arg = state["state_bytes"] + batch_bytes + cache_bytes
    peak = arg + state["gathered_bytes"] + count.peak_live_bytes
    res = {
        "arch": arch, "shape": shape_name, "variant": tag or "baseline",
        "mesh": _mesh_name(layout), "mesh_axes": list(layout),
        "chips": chips, "status": "ok", "device": "meta",
        "state_sharding": STATE_SHARDING,
        "grad_accum": accum, "rank_batch": rank.global_batch,
        "reckon_s": round(t_reckon, 2),
        "params_total": n_total, "params_active": n_active,
        "param_bytes_global": pbytes,
        "mp_sharded_param_leaves": state["mp_leaves"],
        "param_leaves": state["leaves"],
        "memory": {
            "argument_bytes": arg,
            "temp_bytes": count.peak_live_bytes,
            "gathered_bytes": state["gathered_bytes"],
            "output_bytes": count.end_live_bytes,
            "peak_per_chip_est": peak,
            "fits_80gb": peak <= CARD_BYTES,
        },
        "roofline": roof.as_dict(),
        "flops_by_op": count.flops_by_op,
        "collectives": coll,
        "model_flops_global": model_flops,
        "useful_flops_frac": (model_flops / chips) / roof.flops
                             if roof.flops else None,
    }
    if verbose:
        print(f"[{res['mesh']}] {arch} x {shape_name}: reckoned "
              f"{res['reckon_s']}s, mem/rank {peak / 2**30:.2f} GiB "
              f"(fits 80 GB: {peak <= CARD_BYTES}), flops {flops:.4g}, "
              f"bottleneck {roof.bottleneck}, step "
              f"{roof.step_time * 1e3:.2f} ms", flush=True)
    return res


def host_smoke_one(arch: str, *, groups: int = 1, data: int = 4, mp: int = 2,
                   seq_len: int = 128, batch: int = 8,
                   verbose: bool = True) -> dict:
    """Reckon ``arch``'s full train step (one microbatch of ``batch //
    (groups·data)`` sequences a rank) on a (groups, data, mp) layout and
    check that the sharding and the exchange still behave. Returns a
    result dict; raises ``AssertionError`` on a regression:

      * when mp > 1, at least one param leaf is sharded over "mp";
      * the per-rank argument bytes are <= state_bytes / mp * 1.3 + 1 GiB
        (the JAX bound with the port engine's divisor: a replication
        regression inflates them by ~mp and trips);
      * a layout of more than one rank exchanges some bytes;
      * the step's FLOPs are finite and positive.
    """
    cfg = get_config(arch)
    layout = _layout(groups, data, mp)
    need = groups * data * mp
    if batch % (groups * data):
        raise ValueError(f"batch {batch} does not split over "
                         f"{groups}x{data} (group, data) ranks")
    shape = InputShape("hostsmoke", seq_len, batch // (groups * data),
                       "train")
    t0 = time.time()
    pspecs = ST.params_specs(cfg)
    state = rank_state(pspecs, cfg, layout, train=True)
    if mp > 1 and state["mp_leaves"] == 0:
        raise AssertionError(
            f"{arch}: no param leaf is sharded over the 'mp' axis — the "
            "engine's sharding rules regressed (rules.engine_param_specs)")

    pbytes = param_bytes(pspecs)
    mom_bytes = param_count(pspecs) * cfg.dtype("mom").itemsize
    state_bytes = pbytes + mom_bytes
    count, flops, batch_bytes, _ = _count(cfg, shape, 1, pspecs)
    arg = state["state_bytes"] + batch_bytes
    arg_bound = state_bytes / mp * 1.3 + 2.0**30
    if arg > arg_bound:
        raise AssertionError(
            f"{arch}: per-rank argument bytes {arg / 2**30:.1f} GiB exceed "
            f"the sharded-state bound {arg_bound / 2**30:.1f} GiB (state "
            f"{state_bytes / 2**30:.1f} GiB over mp={mp}) — parameters or "
            "momentum replicated?")
    coll = _exchange(pspecs, layout, True, state["mp_leaves"])
    if need > 1 and coll["received"] <= 0:
        raise AssertionError(f"{arch}: no exchange on a {need}-rank layout "
                             "— the engine stopped gathering")
    if not (math.isfinite(flops) and flops > 0):
        raise AssertionError(f"{arch}: the train step counts {flops} FLOPs")
    t_reckon = time.time() - t0

    res = {
        "arch": arch, "shape": "hostsmoke", "status": "ok", "device": "meta",
        "mesh": _mesh_name(layout), "mesh_axes": list(layout),
        "chips": need, "seq_len": seq_len, "global_batch": batch,
        "rank_batch": shape.global_batch, "state_sharding": STATE_SHARDING,
        "reckon_s": round(t_reckon, 2),
        "params_total": param_count(pspecs),
        "state_bytes_global": state_bytes,
        "mp_sharded_param_leaves": state["mp_leaves"],
        "param_leaves": state["leaves"],
        "flops": flops,
        "memory": {
            "argument_bytes": arg,
            "temp_bytes": count.peak_live_bytes,
            "gathered_bytes": state["gathered_bytes"],
            "argument_bound_bytes": arg_bound,
        },
        "collectives": coll,
    }
    if verbose:
        print(f"[host-smoke {res['mesh']}] {arch}: reckoned "
              f"{res['reckon_s']}s, args/rank {arg / 2**30:.1f} GiB "
              f"(bound {arg_bound / 2**30:.1f}), mp-sharded leaves "
              f"{state['mp_leaves']}/{state['leaves']}, flops {flops:.4g}, "
              f"exchange {coll['received'] / 2**30:.2f} GiB in "
              f"{coll['gathers']} gathers", flush=True)
    return res


def run_host_smoke(args) -> None:
    """CLI driver for --host-smoke: every HOST_SMOKE_ARCHS config (or just
    --arch); JSON to --out; exit 1 on any regression."""
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(HOST_SMOKE_ARCHS)
    mesh = f"{args.smoke_g}x{args.smoke_data}x{args.smoke_mp}"
    failures = []
    for arch in archs:
        tag = f"{arch}__hostsmoke__{mesh}"
        try:
            res = host_smoke_one(arch, groups=args.smoke_g,
                                 data=args.smoke_data, mp=args.smoke_mp)
        except Exception as e:  # a failure here is a regression: record it
            traceback.print_exc()
            res = {"arch": arch, "shape": "hostsmoke", "status": "FAILED",
                   "mesh": mesh, "error": str(e)[-2000:]}
            failures.append(tag)
        (out / f"{tag}.json").write_text(json.dumps(res, indent=2))
    if failures:
        print("HOST-SMOKE FAILURES:", failures)
        raise SystemExit(1)
    print(f"host-smoke OK ({len(archs)} configs)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum", type=int, default=None,
                    help="override grad accumulation (hillclimb variant)")
    ap.add_argument("--tag", type=str, default="",
                    help="variant tag appended to the output filename")
    ap.add_argument("--host-smoke", action="store_true",
                    help="regression lane: reckon the big configs' train "
                         "steps on a ('group','data','mp') layout and fail "
                         "on sharding or exchange regressions")
    ap.add_argument("--smoke-g", type=int, default=1,
                    help="host-smoke layout: compute groups")
    ap.add_argument("--smoke-data", type=int, default=4,
                    help="host-smoke layout: data-parallel width")
    ap.add_argument("--smoke-mp", type=int, default=2,
                    help="host-smoke layout: model-parallel width")
    ap.add_argument("--out", type=str, default=str(OUT_DIR),
                    help="directory of the JSON results")
    args = ap.parse_args(argv)

    if args.host_smoke:
        run_host_smoke(args)
        return

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = sorted(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    mesh = _mesh_name(_layout(1, 4, 2))
    failures = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__{mesh}"
            if args.tag:
                tag += f"__{args.tag}"
            try:
                res = reckon_one(arch, shape, accum_override=args.accum,
                                 tag=args.tag)
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                res = {"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "FAILED", "error": str(e)[-2000:]}
                failures.append(tag)
            (out / f"{tag}.json").write_text(json.dumps(res, indent=2))
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("all dry-runs OK")


if __name__ == "__main__":
    main()
