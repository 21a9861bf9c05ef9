"""Execution-strategy plugins behind ``Engine.step`` / ``Engine.run`` (the
JAX package's ``engine/strategies.py``, single device):

  sync           g=1 synchronous data-parallel SGD (the grouped step's
                 exact g=1 reduction; pinned to g=1)
  grouped-fused  g async compute groups, closed-form fused update
  grouped-scan   g async compute groups, literal O(g) sequential update

``delayed`` (Theorem-1-exact delayed SGD) and ``trace-replay`` are not
ported yet: asking for them raises ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.async_sgd import make_grouped_train_step
from repro_torch.core.compute_groups import group_batch_split

_REGISTRY: Dict[str, "Strategy"] = {}
_NOT_PORTED = {
    "delayed": "ROADMAP Queue A item 5 (core/async_sgd.delayed_sgd_run)",
    "trace-replay": "ROADMAP Queue A item 13 (exec/replay.py)",
}


def register_strategy(cls):
    inst = cls()
    _REGISTRY[inst.name] = inst
    return cls


def get_strategy(name: str) -> "Strategy":
    if name in _NOT_PORTED:
        raise NotImplementedError(f"strategy {name!r} is not ported yet: "
                                  f"{_NOT_PORTED[name]}")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"known: {sorted(_REGISTRY)}") from None


def list_strategies():
    return tuple(sorted(_REGISTRY))


class Strategy:
    """Interface: ``build_step`` returns a per-round step."""
    name = "?"

    def build_step(self, engine, *, g: int, lr: float, momentum: float):
        raise NotImplementedError(f"{self.name} has no per-round step")


class _BuiltStep:
    """A built step + its batch-preparation recipe."""

    def __init__(self, fn: Callable, prepare: Callable):
        self.fn = fn              # (params, mom, grouped batch)
        self.prepare = prepare    # global batch -> (g, ...) grouped batch

    def __call__(self, params, mom, batch):
        return self.fn(params, mom, self.prepare(batch))


class GroupedStrategy(Strategy):
    """g async compute groups; subclasses pick the update application."""
    update = "fused"

    def build_step(self, engine, *, g, lr, momentum):
        with engine.tracer.span("engine.build_step", strategy=self.name,
                                g=g, mode=engine.exec_mode):
            fn = make_grouped_train_step(
                engine.loss_fn, num_groups=g, lr=lr, momentum=momentum,
                weight_decay=engine.weight_decay, strategy=self.update,
                head_filter=engine.head_filter,
                update_impl=engine.update_impl)

            def prepare(batch):
                return group_batch_split(batch, g)

        return _BuiltStep(fn, prepare)


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
    g=1: asking it for g>1 is a configuration error, not a silent
    strategy change."""
    name = "sync"
    update = "fused"

    def build_step(self, engine, *, g, lr, momentum):
        if g != 1:
            raise ValueError(f"strategy 'sync' is pinned to g=1, got g={g}; "
                             "use grouped-fused/grouped-scan for g>1")
        return super().build_step(engine, g=g, lr=lr, momentum=momentum)
