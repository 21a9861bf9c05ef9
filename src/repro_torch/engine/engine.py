"""The execution engine behind the training loop (the JAX package's
``engine/engine.py``, on one device).

``Engine`` owns batch preparation (group split, sized heterogeneous
shares) and prefetch onto the card, the strategy's per-round step
(``engine.strategies``), and per-step observability: ``timing.Telemetry``
(step_s / data_wait_s / h2d_s / loss series on an ``obs.metrics``
registry) and ``obs.spans`` spans around every phase of a round (data
wait, dispatch, the synchronizing loss read).

Single device: ``exec_mode="vmap"`` — the g groups' gradients are taken
one after another on the one card, at the round-start parameters. The
SPMD group mesh (``"spmd"``, ``"reference"``), the Algorithm-1 Runner
protocol, ``profile`` and checkpoint hooks are not ported yet (ROADMAP
Queue A items 8, 9, 14), and so are the heterogeneous planner's per-group
weights and batch sizes (item 14; ``make_grouped_train_step`` and
``group_batch_split`` take them).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

from repro_torch.core import tree as T
from repro_torch.core.compute_groups import GroupSpec
from repro_torch.data.pipeline import prefetch
from repro_torch.device import check_update_impl, resolve
from repro_torch.engine import timing
from repro_torch.engine.strategies import Strategy, get_strategy
from repro_torch.obs import spans

_END = object()     # prefetch-exhausted sentinel
PREFETCH_DEPTH = 2  # batches copied ahead of the step


class Engine:
    """Single-device execution engine (see module docstring).

    ``loss_fn(params, batch) -> scalar tensor`` is the only model
    contract. ``device`` (default ``"cuda"``, raising without a card) is
    where batches are copied and the step runs; ``update_impl`` is the
    fused update's leaf path (``"cuda"`` the kernel, ``"torch"`` the plain
    version, which a CPU device needs). The conv arm is the model's own
    (``CNNConfig.conv_impl``, default ``"lowering_cuda"``).
    """

    def __init__(self, loss_fn: Callable, *, strategy: str = "grouped-fused",
                 num_groups: int = 1, lr: float = 0.02, momentum: float = 0.0,
                 weight_decay: float = 0.0,
                 head_filter: Optional[Callable] = None,
                 update_impl: str = "cuda", exec_mode: str = "vmap",
                 device="cuda", tracer=None):
        if exec_mode in ("spmd", "reference"):
            raise NotImplementedError(
                f"exec_mode={exec_mode!r} is not ported yet: the group mesh "
                "is ROADMAP Queue A item 8; this engine runs 'vmap'")
        if exec_mode != "vmap":
            raise ValueError(f"unknown exec_mode {exec_mode!r}")
        self.device = resolve(device)
        check_update_impl(update_impl, self.device)
        self.loss_fn = loss_fn
        self.strategy: Strategy = get_strategy(strategy)
        self.num_groups = int(num_groups)
        self.lr, self.momentum, self.weight_decay = lr, momentum, weight_decay
        self.head_filter = head_filter
        self.update_impl = update_impl
        self.exec_mode = exec_mode
        self.telemetry = timing.Telemetry()
        self.tracer = tracer if tracer is not None else spans.current()
        self._step = self.strategy.build_step(self, g=self.num_groups, lr=lr,
                                              momentum=momentum)

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------

    def group_spec(self, g: Optional[int] = None) -> GroupSpec:
        g = self.num_groups if g is None else g
        return GroupSpec(num_groups=g, num_devices=g)

    def describe(self) -> str:
        spec = self.group_spec()
        return (f"engine[{self.strategy.name}] g={spec.num_groups} "
                f"S={spec.staleness} "
                f"mu_implicit={spec.implicit_momentum:.3f} "
                f"exec={self.exec_mode} "
                f"device={self.device.type} update={self.update_impl}")

    # ------------------------------------------------------------------
    # per-round step and whole runs
    # ------------------------------------------------------------------

    def step(self, params, mom, batch):
        """One timed round on the global ``batch`` (a dict of device
        tensors with leaves (B, ...), B divisible by g). Returns
        ``(params, mom, loss)`` (new trees; the caller's are not changed);
        the wall time, which ends in the synchronizing loss read, lands in
        telemetry."""
        with self.tracer.span("engine.step", g=self.num_groups,
                              mode=self.exec_mode):
            t0 = timing.monotonic()
            params, mom, loss = self._step(params, mom, batch)
            float(loss)
            self.telemetry.record(step_s=timing.monotonic() - t0)
        return params, mom, loss

    def run(self, params, mom, batches: Iterable, *, steps: int,
            log_every: int = 0, log: Callable = print):
        """Drive ``steps`` rounds from an iterator of host (numpy) batches
        with prefetch onto the device and telemetry. The caller's
        ``params`` / ``mom`` are copied onto the device first and never
        changed. Returns ``(params, mom, losses)`` (losses: Python
        floats)."""
        params = T.tree_map(
            lambda t: t.detach().to(self.device, copy=True), params)
        mom = T.tree_map(lambda t: t.detach().to(self.device, copy=True), mom)
        tracer = self.tracer
        losses = []
        loss_series = self.telemetry.registry.series("loss")
        it = prefetch(iter(batches), depth=PREFETCH_DEPTH, tracer=tracer,
                      metrics=self.telemetry.registry, device=self.device)
        with tracer.span("engine.run", strategy=self.strategy.name,
                         g=self.num_groups, steps=steps):
            t_prev = timing.monotonic()
            for i in range(steps):
                with tracer.span("engine.data_wait", step=i):
                    batch = next(it, _END)
                if batch is _END:
                    break
                t_ready = timing.monotonic()
                with tracer.span("engine.step", step=i, mode=self.exec_mode):
                    with tracer.span("engine.dispatch"):
                        params, mom, loss = self._step(params, mom, batch)
                    with tracer.span("engine.sync"):
                        losses.append(float(loss))   # step wall ends here
                t_done = timing.monotonic()
                self.telemetry.record(step_s=t_done - t_ready,
                                      data_s=t_ready - t_prev)
                loss_series.append(losses[-1], step=i)
                t_prev = t_done
                if log_every and i % log_every == 0:
                    log(f"step {i:5d} loss {losses[-1]:.4f} "
                        f"({(t_done - t_ready) * 1e3:.0f} ms/it)")
        return params, mom, losses
