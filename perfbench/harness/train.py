"""The training-round runner: ``Engine.run`` over a pool of host batches.

Set-up makes the weights and the data pool from the seed, builds one
``Engine`` on the configuration's family (``families/<family>.py``), then
drives that engine through its first rounds, one ``Engine.run`` call
each, on pool batches that all differ. Those rounds
warm every shape the window uses, and they are what the plain reference
follows. The state lives on the host between calls (pinned), so a call's
copy onto the card is the only copy there: (4 + g) P of state at the
update, as a user's run holds.

The window is one ``Engine.run`` call of N rounds, N set so the window
lasts about ``--seconds``. It starts when the engine first asks the
benchmark's feed for a batch (after its copy of the state onto the card)
and ends when the call returns: every round's data wait, dispatch and
synchronizing loss read is inside. ``train_round_ms`` is its length over
the rounds. With ``--trace 1`` the profiler covers the last rounds (see
``harness.trace``); the rounds before them stay unprofiled and give the
round time that ``mfu.train`` divides by.

Across ranks every rank runs this same code on its own card; rank 0's
numbers and rank 0's state are the ones reported and judged.
"""
from __future__ import annotations

import dataclasses
import gc
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import common, judge
from harness.common import clock
from harness.trace import DeviceTrace
from harness.weights import leaves_with_paths, path_name

TRACE_SECONDS = 3.0      # the profiled stretch of a traced window
MIN_TRACED_ROUNDS = 3


@dataclasses.dataclass
class Options:
    """Where a run drives the program: the card by default; the tests
    run small cells' plain paths on the CPU."""
    device: str = "cuda"
    rank: int = 0
    world: int = 1


class Feed:
    """The window's batches: pool batches from ``start`` on, ``n`` of them.
    Records when the engine asks for each (the engine's prefetch asks for
    batch k + 2 as round k begins, after round k - 1's loss read), and
    starts, marks and stops the profiler at those moments."""

    def __init__(self, pool, start: int, n: int, trace: Optional[DeviceTrace]
                 = None, traced: int = 0):
        self.pool, self.start, self.n = pool, start, n
        self.trace, self.traced = trace, traced
        self.pulls: List[float] = []

    def __iter__(self):
        for k in range(self.n):
            self.pulls.append(clock())
            if self.trace is not None:
                first = self.n - self.traced        # first counted round
                if k == first + 1:                   # round first - 1 begins
                    self.trace.start()
                elif k == first + 2:                 # round first begins
                    self.trace.mark()
            yield self.pool[(self.start + k) % len(self.pool)]

    def round_start(self, r: int) -> float:
        """Host time round ``r`` began (r >= 1)."""
        return self.pulls[r + 2] if r >= 1 else self.pulls[0]


def _host_copy(tree, into=None):
    """Device tree -> pinned host copies (into ``into``'s tensors)."""
    pin = torch.cuda.is_available()
    if into is None:
        return _map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=pin).copy_(t), tree)
    _zip(lambda d, h: h.copy_(d), tree, into)
    return into


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _zip(fn, a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _zip(fn, x, y)
    else:
        fn(a, b)


def leaf_norms(tree) -> Dict[str, float]:
    return {path_name(p): float(torch.linalg.vector_norm(
        t.detach(), dtype=torch.float64)) for p, t in leaves_with_paths(tree)}


def change_norms(tree, w0) -> Dict[str, float]:
    flat0 = dict((path_name(p), t) for p, t in leaves_with_paths(w0))
    return {path_name(p): float(torch.linalg.vector_norm(
        (t.detach().float() - flat0[path_name(p)].to(t.device).float()),
        dtype=torch.float64)) for p, t in leaves_with_paths(tree)}


class TrainRun:
    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 opts: Options, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.want_trace, self.opts, self.t_start = trace, opts, t_start
        self.s = cell.settings
        self.device = torch.device(opts.device)

    # -- the program ------------------------------------------------------

    def _program(self):
        from repro_torch.engine import Engine
        s, config = self.s, self.cell.config
        loss_fn, head, params = common.family(config).train_program(
            config, s, self.seed, self.device)
        engine = Engine(loss_fn, strategy=s["strategy"],
                        num_groups=int(s["groups"]), lr=float(s["lr"]),
                        momentum=float(s["momentum"]), head_filter=head,
                        update_impl=s["update_impl"],
                        exec_mode=s.get("exec_mode", "vmap"),
                        device=self.device)
        return engine, params

    # -- the run ----------------------------------------------------------

    def run(self) -> Dict:
        from repro_torch.obs import spans
        s = self.s
        mix, config = self.cell.traffic, self.cell.config
        pool = common.generator(mix)(mix, config, self.seed, self.seconds,
                                     self.device)
        self.pool = pool
        tracer = spans.Tracer() if self.want_trace else None
        with spans.install(tracer if tracer is not None else spans.current()):
            engine, params = self._program()
        host_p = _host_copy(params)
        del params
        gc.collect()
        host_v = _map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                            pin_memory=t.is_pinned()), host_p)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        steps = int(s["check_steps"])
        losses, grad1, t_last = [], None, 0.0
        for i in range(steps):
            feed = Feed(pool, i, 1)
            p, v, ls = engine.run(host_p, host_v, feed, steps=1)
            t_last = clock() - feed.pulls[0]
            losses.append(float(ls[0]))
            if i == 0:
                grad1 = leaf_norms(v)
            if i == steps - 1:
                w0 = common.family(config).params(config, self.seed,
                                                  self.device)
                change = change_norms(p, w0)
                del w0
            _host_copy(p, host_p)
            _host_copy(v, host_v)
            del p, v
        n = max(MIN_TRACED_ROUNDS + 3,
                int(math.ceil(self.seconds / max(t_last, 1e-3))))
        n = self._agree(n)
        traced = 0
        dtrace = None
        if self.want_trace:
            traced = max(MIN_TRACED_ROUNDS,
                         min(n // 3, int(round(TRACE_SECONDS
                                               / max(t_last, 1e-3)))))
            dtrace = DeviceTrace()
        t_setup = clock() - self.t_start
        feed = Feed(pool, steps, n, dtrace, traced)
        with spans.install(tracer if tracer is not None else spans.current()):
            p, v, ls = engine.run(host_p, host_v, feed, steps=n)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            t_end = clock()
            if dtrace is not None:
                dtrace.stop()
        window = t_end - feed.pulls[0]
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        del p, v, engine
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if traced:              # the rounds before the profiler started
            first = n - traced
            clean = (feed.pulls[0], feed.round_start(first - 1), first - 1)
        else:
            clean = (feed.pulls[0], t_end, len(ls))
        out = {"end_to_end": {"setup_s": t_setup, "train_round_ms":
                              1e3 * window / max(1, len(ls))},
               "window_s": window, "rounds": len(ls), "clean": clean,
               "losses": losses, "grad1": grad1, "change": change,
               "peak": peak, "trace": dtrace, "tracer": tracer,
               "feed": feed, "traced": traced, "finite": bool(
                   np.all(np.isfinite(ls))),
               "note": f"window losses: first {ls[0]!r}, last {ls[-1]!r}, "
                       f"{int(np.sum(~np.isfinite(ls)))} not finite"}
        return out

    def _agree(self, n: int) -> int:
        """Every rank runs rank 0's round count."""
        if self.opts.world == 1:
            return n
        import torch.distributed as dist
        box = [n]
        dist.broadcast_object_list(box, src=0)
        return int(box[0])

    # -- the comparison ---------------------------------------------------

    def judge(self, out: Dict, mode: str = "fp32", **fault) -> Dict:
        """The plain reference's rounds on the same weights and batches;
        returns the compared numbers."""
        ref = judge.train_reference(self.cell, self.seed, self.pool,
                                    int(self.s["check_steps"]), self.device,
                                    mode=mode, **fault)
        return judge.train_numbers(out, ref)


Run = TrainRun
