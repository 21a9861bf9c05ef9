"""Execution-strategy plugins behind ``Engine.step`` / ``Engine.run`` and
the Algorithm-1 Runner (the JAX package's ``engine/strategies.py``):

  sync           g=1 synchronous data-parallel SGD (the grouped step's
                 exact g=1 reduction; pinned to g=1)
  grouped-fused  g async compute groups, closed-form fused update
  grouped-scan   g async compute groups, literal O(g) sequential update
  delayed        exact delayed SGD (staleness S=g-1, paper Theorem 1) —
                 the default Runner substrate for Algorithm 1
  trace-replay   momentum-SGD executed along a recorded ``EventTrace``
                 (``exec.replay``): one stale commit per trace event

A strategy provides ``build_step`` (a per-round step + batch preparation)
and/or ``run_stacked`` (a whole-run loop over stacked batches, used by
the Runner protocol, ``Engine.__call__``). ``build_step`` places the step
by the engine's resolved mode (``Engine._resolve_exec``): ``"spmd"``
(this rank's step over the group mesh, ``engine.spmd``), ``"reference"``
(its single-process bitwise twin) or ``"vmap"`` (the g groups' gradients
one after another on one device, ``core.async_sgd``). ``trace-replay``
provides ``replay`` instead, which ``Engine.replay`` drives.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.core.async_sgd import (delayed_sgd_run,
                                       make_grouped_train_step)
from repro_torch.core.compute_groups import group_batch_split
from repro_torch.engine.spmd import (device_batch_split,
                                     make_reference_grouped_step,
                                     make_spmd_grouped_step)

_REGISTRY: Dict[str, "Strategy"] = {}


def register_strategy(cls):
    inst = cls()
    _REGISTRY[inst.name] = inst
    return cls


def get_strategy(name: str) -> "Strategy":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"known: {sorted(_REGISTRY)}") from None


def list_strategies():
    return tuple(sorted(_REGISTRY))


class Strategy:
    """Interface. ``supports_step``: has a per-round ``step``;
    ``supports_runner``: usable as the Algorithm-1 Runner substrate."""
    name = "?"
    supports_step = True
    supports_runner = True

    def build_step(self, engine, *, g: int, lr: float, momentum: float,
                   per_group_batch: int):
        raise NotImplementedError(f"{self.name} has no per-round step")

    def run_stacked(self, engine, params, batches, *, g: int, lr: float,
                    momentum: float):
        raise NotImplementedError(f"{self.name} cannot drive a stacked run")


class _BuiltStep:
    """A built step and its batch recipe.

    ``local(batch)``: a global batch (host arrays or device tensors) ->
    what this rank feeds the step (its (group, data) shard under spmd, the
    whole batch otherwise); ``prepare``: that batch on the device -> the
    step's input. ``fn`` is this rank's ``SpmdStep`` under spmd (its
    ``shard`` / ``unshard`` move full trees to the rank's storage), None on
    a rank outside the mesh.
    spmd/reference steps return (g, k) per-shard losses; ``__call__``
    reduces them on the host in float64, so every mode reports one
    deterministic scalar."""

    def __init__(self, fn: Callable, prepare: Callable, mode: str, g: int,
                 k: int, coord=None, sizes=None):
        self.fn = fn              # (params, mom, prepared batch)
        self.prepare = prepare    # local device batch -> the step's input
        self.mode = mode          # "spmd" | "reference" | "vmap"
        self.g, self.k = g, k
        self.coord = coord        # this rank's (group, data, mp) under spmd
        self.sizes = sizes        # per-group shares (None: equal)

    @property
    def idle(self) -> bool:
        """This rank lies outside the group mesh (a world larger than
        g·k·mp): it runs no step, and ``Engine`` hands it rank 0's
        results."""
        return self.mode == "spmd" and self.fn is None

    def local(self, batch):
        if self.mode != "spmd":
            return batch
        gi, ki, _ = self.coord
        return T.tree_map(lambda x: x[gi, ki],
                          device_batch_split(group_batch_split(
                              batch, self.g, sizes=self.sizes), self.k))

    def shard(self, tree):
        return tree if self.mode != "spmd" or self.idle else self.fn.shard(
            tree)

    def unshard(self, tree):
        return tree if self.mode != "spmd" or self.idle else self.fn.unshard(
            tree)

    @staticmethod
    def scalar_loss(loss) -> float:
        if loss.dim() == 0:
            return float(loss)
        return float(np.asarray(loss.detach().cpu(), np.float64).mean())

    def __call__(self, params, mom, batch):
        """-> (params, mom, loss tensor: 0-d under vmap, (g, k) else)."""
        return self.fn(params, mom, self.prepare(batch))


class GroupedStrategy(Strategy):
    """g async compute groups; subclasses pick the update application."""
    update = "fused"

    def build_step(self, engine, *, g, lr, momentum, per_group_batch):
        with engine.tracer.span("engine.build_step", strategy=self.name,
                                g=g) as sp:
            mode, k, mesh = engine._resolve_exec(g, per_group_batch)
            sp.set(mode=mode, k=k)
            sizes = engine._sizes_for(g)
            common = dict(lr=lr, momentum=momentum,
                          weight_decay=engine.weight_decay,
                          strategy=self.update,
                          head_filter=engine.head_filter,
                          group_weights=engine._weights_for(g),
                          update_impl=engine.update_impl)
            coord = None
            if mode == "spmd":
                fn = None       # a rank past the mesh runs no step
                if mesh.get_coordinate() is not None:
                    fn = make_spmd_grouped_step(
                        engine.loss_fn, mesh,
                        bucket_bytes=engine.bucket_bytes,
                        sharding_rules=engine.sharding_rules, **common)
                    coord = fn.coord

                def prepare(batch):
                    return batch
            elif mode == "reference":
                fn = make_reference_grouped_step(engine.loss_fn, g, k,
                                                 **common)

                def prepare(batch):
                    return device_batch_split(
                        group_batch_split(batch, g, sizes=sizes), k)
            else:
                fn = make_grouped_train_step(engine.loss_fn, num_groups=g,
                                             **common)

                def prepare(batch):
                    return group_batch_split(batch, g, sizes=sizes)

        return _BuiltStep(fn, prepare, mode, g, k, coord, sizes)

    def run_stacked(self, engine, params, batches, *, g, lr, momentum):
        """``T`` rounds over stacked ``batches`` (leaves (T, B, ...) on the
        engine's device) from zero momentum, through the step built once
        for (strategy, g, lr, mu, per-group batch) and reused by every
        later probe at that point. Returns (final params, losses (T,)
        numpy): the round's mean loss, over the (g, k) shards under
        spmd/reference."""
        b = T.leaves(batches)[0].shape[1]
        step = engine._step_for(self, g=g, lr=lr, momentum=momentum,
                                per_group_batch=engine._per_group_batch(g,
                                                                        b))
        if step.idle:
            raise ValueError("the Runner protocol needs every rank in the "
                             "group mesh; this rank lies past it")
        p = step.shard(params)
        v = step.shard(T.tree_map(torch.zeros_like, params))
        losses = []
        for t in range(T.leaves(batches)[0].shape[0]):
            batch = step.local(T.tree_map(lambda x: x[t], batches))
            if step.mode == "spmd":
                # a tensor of its own, as ``Engine.run``'s copy gives it
                batch = T.tree_map(lambda x: x.clone(), batch)
            p, v, loss = step(p, v, batch)
            losses.append(loss.detach().float())
        losses = torch.stack(losses).cpu().numpy()
        if losses.ndim > 1:                    # (T, g, k) per-shard losses
            losses = losses.mean(axis=tuple(range(1, losses.ndim)))
        return step.unshard(p), losses


@register_strategy
class GroupedFusedStrategy(GroupedStrategy):
    name = "grouped-fused"
    update = "fused"


@register_strategy
class GroupedScanStrategy(GroupedStrategy):
    name = "grouped-scan"
    update = "scan"


@register_strategy
class SyncStrategy(GroupedStrategy):
    """Synchronous data-parallel SGD = the grouped step at g=1. Pinned to
    g=1 by ``Engine``: asking it for g>1 is a configuration error, not a
    silent strategy change."""
    name = "sync"
    update = "fused"

    def run_stacked(self, engine, params, batches, *, g, lr, momentum):
        if g != 1:
            raise ValueError(f"strategy 'sync' is pinned to g=1, got g={g}; "
                             "use grouped-fused/grouped-scan for g>1")
        return super().run_stacked(engine, params, batches, g=g, lr=lr,
                                   momentum=momentum)


@register_strategy
class DelayedStrategy(Strategy):
    """Theorem-1-exact delayed SGD (gradient at W_{t-S}, S=g-1). Carries an
    (S+1)-deep parameter history — the statistical-efficiency substrate,
    and the default Runner behind ``workload.make_runner``."""
    name = "delayed"
    supports_step = False

    def run_stacked(self, engine, params, batches, *, g, lr, momentum):
        final, losses, _ = delayed_sgd_run(
            engine.loss_fn, params, batches, staleness=g - 1, lr=lr,
            momentum=momentum, weight_decay=engine.weight_decay)
        return final, losses.float().cpu().numpy()


@register_strategy
class TraceReplayStrategy(Strategy):
    """Execute momentum-SGD along the engine's recorded ``EventTrace``
    (``exec.replay``): one stale commit per trace event instead of
    round-robin rounds. Run-level only — per-commit staleness needs the
    whole schedule, so there is no per-round ``step`` and no Runner."""
    name = "trace-replay"
    supports_step = False
    supports_runner = False

    def replay(self, engine, params, batches, trace=None):
        """``trace`` (e.g. a truncated view) overrides ``engine.trace``."""
        from repro_torch.exec.replay import replay_trace
        trace = engine.trace if trace is None else trace
        if trace is None:
            raise ValueError("strategy 'trace-replay' needs Engine(trace=...)")
        return replay_trace(
            engine.loss_fn, params, batches, trace, lr=engine.lr,
            momentum=engine.momentum, weight_decay=engine.weight_decay,
            impl=engine.replay_impl, depth=engine.replay_depth)
