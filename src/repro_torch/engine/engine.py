"""The execution engine behind the training loop (the JAX package's
``engine/engine.py``).

``Engine`` owns batch preparation (group split, per-worker shards) and
prefetch onto the device, the strategy's per-round step
(``engine.strategies``), checkpoint hooks, and per-step observability:
``timing.Telemetry`` (step_s / data_wait_s / h2d_s / loss series on an
``obs.metrics`` registry) and ``obs.spans`` spans around every phase of a
round (data wait, dispatch, the synchronizing loss read, checkpoint).

Placement (``exec_mode``):

  "vmap"       (default) one device: the g groups' gradients one after
               another at the round-start parameters
  "spmd"       the ("group", "data", "mp") mesh over the first g·k·mp
               ranks of the initialized process group (``engine.spmd``;
               every rank runs the engine on the same global batches;
               ranks past the mesh run no round and get rank 0's results)
  "reference"  the single-process bitwise twin of the SPMD step, over the
               same (g, k) shard structure
  "auto"       spmd when a process group of world size >= g is
               initialized, else vmap

The heterogeneous planner's allocation enters as ``group_weights`` (each
group's gradient weighted by its batch share) and ``micro_sizes`` (each
group's share of the global batch, wrap-filled to the largest); both
apply when their length is the round's g. An ``Engine`` is also the
Algorithm-1 ``Runner`` (``core.auto_optimizer``): ``engine(state, g=,
mu=, eta=, steps=, probe=)`` draws ``steps`` batches from
``sample_batches`` and runs them through the strategy's ``run_stacked``.
``profile`` is the cluster subsystem's black-box probe of the engine's own
step. With ``trace=`` and strategy ``"trace-replay"``, ``run`` executes
momentum-SGD along the recorded ``EventTrace`` instead (``replay``: one
stale commit per trace event, ``exec.replay``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.core.compute_groups import GroupSpec
from repro_torch.data.pipeline import prefetch
from repro_torch.device import check_update_impl, resolve
from repro_torch.engine import timing
from repro_torch.engine.spmd import DEFAULT_BUCKET_BYTES, choose_data_parallel
from repro_torch.engine.strategies import Strategy, get_strategy
from repro_torch.obs import spans

_END = object()     # prefetch-exhausted sentinel
PREFETCH_DEPTH = 2  # batches copied ahead of the step
EXEC_MODES = ("auto", "spmd", "reference", "vmap")


def rank_and_world():
    """(rank, world size) of the initialized process group, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Engine:
    """Execution engine (see module docstring).

    ``loss_fn(params, batch) -> scalar tensor`` is the only model
    contract. ``device`` (default ``"cuda"``, raising without a card) is
    where batches are copied and the step runs; ``update_impl`` is the
    fused update's leaf/slab path (``"cuda"`` the kernel, ``"torch"`` the
    plain version, which a CPU device needs). The conv arm is the model's
    own (``CNNConfig.conv_impl``, default ``"lowering_cuda"``).

    ``num_devices``: the device pool whose (g, k) shard structure the
    "reference" mode mirrors (default: the world size). ``mp``: ranks per
    worker holding parameter/momentum shards (spmd; the world becomes
    g·k·mp). ``sharding_rules``: explicit ``(regex-path-window, spec)``
    rules over the derived specs. ``bucket_bytes``: slab size target of
    the SPMD exchange (0: the whole-tree arm). ``checkpoint_dir`` /
    ``checkpoint_every``: ``run`` saves ``{"params", "mom"}`` (full trees,
    from rank 0) every that many rounds.

    ``group_weights`` / ``micro_sizes``: the planner's per-group batch
    shares (``cluster.Plan.weights``, ``Plan.allocation.microbatches``).
    ``sample_batches(generator, steps, batch_size)`` + ``batch_size``
    enable the Runner protocol (``__call__``); ``seed`` seeds its stream.
    ``trace`` / ``replay_impl`` (``"scan"``, ``"python"`` or ``"fused"``)
    / ``replay_depth`` (a cap on the parameter-history ring) serve the
    ``"trace-replay"`` strategy.
    """

    def __init__(self, loss_fn: Callable, *, strategy: str = "grouped-fused",
                 num_groups: int = 1, lr: float = 0.02, momentum: float = 0.0,
                 weight_decay: float = 0.0,
                 group_weights: Optional[Sequence[float]] = None,
                 micro_sizes: Optional[Sequence[int]] = None,
                 head_filter: Optional[Callable] = None,
                 update_impl: str = "cuda", exec_mode: str = "vmap",
                 num_devices: Optional[int] = None, mp: int = 1,
                 sharding_rules=None,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 sample_batches: Optional[Callable] = None,
                 batch_size: Optional[int] = None, seed: int = 0,
                 trace=None, replay_impl: str = "scan",
                 replay_depth: Optional[int] = None,
                 checkpoint_dir: str = "", checkpoint_every: int = 0,
                 device="cuda", tracer=None):
        if exec_mode not in EXEC_MODES:
            raise ValueError(f"unknown exec_mode {exec_mode!r}")
        self.device = resolve(device)
        check_update_impl(update_impl, self.device)
        self.loss_fn = loss_fn
        self.strategy: Strategy = get_strategy(strategy)
        self.num_groups = int(num_groups)
        if self.strategy.name == "sync" and self.num_groups != 1:
            raise ValueError(f"strategy 'sync' is pinned to g=1, got "
                             f"g={self.num_groups}; use grouped-fused/"
                             "grouped-scan for g>1")
        self.lr, self.momentum, self.weight_decay = lr, momentum, weight_decay
        self.group_weights = (tuple(float(w) for w in group_weights)
                              if group_weights is not None else None)
        self.micro_sizes = (tuple(int(s) for s in micro_sizes)
                            if micro_sizes is not None else None)
        self.head_filter = head_filter
        self.update_impl = update_impl
        self.exec_mode, self.num_devices = exec_mode, num_devices
        self.mp = int(mp)
        if self.mp < 1:
            raise ValueError(f"mp must be >= 1, got {mp}")
        if self.mp > 1 and exec_mode == "vmap":
            raise ValueError("exec_mode='vmap' has no model-parallel path; "
                             "use exec_mode='spmd' (or 'auto') for mp > 1")
        self.sharding_rules = (tuple(sharding_rules)
                               if sharding_rules is not None else None)
        self.bucket_bytes = int(bucket_bytes)
        self.sample_batches, self.batch_size = sample_batches, batch_size
        self.seed = seed
        self.trace = trace
        self.replay_impl, self.replay_depth = replay_impl, replay_depth
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.telemetry = timing.Telemetry()
        self.tracer = tracer if tracer is not None else spans.current()
        #: (g, k) per-shard losses of each spmd/reference round (numpy)
        self.shard_losses: list = []
        self._steps: dict = {}
        self._meshes: dict = {}

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------

    def _weights_for(self, g: int):
        if self.group_weights is not None and len(self.group_weights) == g:
            return self.group_weights
        return None

    def _sizes_for(self, g: int):
        if self.micro_sizes is not None and len(self.micro_sizes) == g:
            return self.micro_sizes
        return None

    def _resolve_exec(self, g: int, per_group_batch: int):
        """-> (mode, k, mesh or None). k data-parallel slots per group come
        out of n // (g·mp), n the world size (or ``num_devices``)."""
        _, world = rank_and_world()
        n = self.num_devices if self.num_devices is not None else world
        mp = self.mp
        if self.exec_mode == "vmap":
            return "vmap", 1, None
        if self.exec_mode == "reference":
            # one process; n only shapes the (g, k) structure mirrored,
            # narrowed by mp as the SPMD mesh is
            return ("reference",
                    choose_data_parallel(per_group_batch,
                                         max(1, n // (g * mp)), warn=False),
                    None)
        slots = n // (g * mp)
        k = choose_data_parallel(per_group_batch, slots) if slots >= 1 else 0
        if self.exec_mode == "auto" and mp == 1 and (n <= 1 or k < 1):
            return "vmap", 1, None
        if k < 1:
            raise ValueError(
                f"exec_mode={self.exec_mode!r} needs >= {g * mp} ranks "
                f"for g={g}, mp={mp} (have {n})")
        if k < slots:
            self.telemetry.note(
                f"stranded devices: g={g} mp={mp} uses k={k} of {slots} "
                f"per-group device slots (per-group batch "
                f"{per_group_batch} has no larger divisor)")
        if g * k * mp < world:
            self.telemetry.note(
                f"idle ranks: the ({g},{k},{mp}) mesh holds ranks 0.."
                f"{g * k * mp - 1} of {world}; the others run no round and "
                "receive rank 0's results")
        mesh = self._meshes.get((g, k, mp))
        if mesh is None:
            from repro_torch.launch.mesh import make_group_mesh
            mesh = make_group_mesh(g, k, mp, device_type=self.device.type)
            self._meshes[(g, k, mp)] = mesh
        return "spmd", k, mesh

    def _step_for(self, strategy: Strategy, *, g: int, lr: float,
                  momentum: float, per_group_batch: int):
        """The step for one (strategy, g, lr, mu, per-group batch), built
        once: Algorithm 1's Runner re-probes the same point many times."""
        key = (strategy.name, g, lr, momentum, per_group_batch)
        step = self._steps.get(key)
        if step is None:
            step = strategy.build_step(self, g=g, lr=lr, momentum=momentum,
                                       per_group_batch=per_group_batch)
            self._steps[key] = step
        return step

    def _built_step(self, per_group_batch: int):
        """The engine's own step (its strategy, g, lr and mu)."""
        if not self.strategy.supports_step:
            raise ValueError(
                f"strategy {self.strategy.name!r} has no per-round step; "
                "drive it through the Runner protocol (Engine.__call__)")
        return self._step_for(self.strategy, g=self.num_groups, lr=self.lr,
                              momentum=self.momentum,
                              per_group_batch=per_group_batch)

    def _round_step(self, global_batch: int):
        """The engine's own step for rounds of ``global_batch`` examples."""
        return self._built_step(self._per_group_batch(self.num_groups,
                                                      global_batch))

    def _per_group_batch(self, g: int, global_batch: int) -> int:
        sizes = self._sizes_for(g)
        if sizes is not None:
            return max(sizes)     # sized splits wrap-fill to max(sizes)
        if global_batch % g:
            raise ValueError(f"batch {global_batch} not divisible by g={g}")
        return global_batch // g

    def group_spec(self, g: Optional[int] = None) -> GroupSpec:
        g = self.num_groups if g is None else g
        n = self.num_devices if self.num_devices is not None \
            else rank_and_world()[1]
        return GroupSpec(num_groups=g, num_devices=max(g, (n // g) * g))

    def describe(self, per_group_batch: Optional[int] = None) -> str:
        spec = self.group_spec()
        g = spec.num_groups
        mode, k, _ = self._resolve_exec(
            g, per_group_batch if per_group_batch is not None
            else max(1, spec.group_size))
        mesh_s = ""
        if mode == "spmd":
            mesh_s = (f"({g}x{k}x{self.mp} mesh)" if self.mp > 1
                      else f"({g}x{k} mesh)")
        return (f"engine[{self.strategy.name}] g={g} S={spec.staleness} "
                f"mu_implicit={spec.implicit_momentum:.3f} "
                f"exec={mode}{mesh_s} "
                f"device={self.device.type} update={self.update_impl}")

    def shard_layout(self, params, per_group_batch: int):
        """This rank's mp storage of ``params`` (full trees): a tree of
        ``None`` or ``(dim, index, count)`` per leaf, the ``shards`` of
        ``checkpoint.restore``. All ``None`` unless spmd with mp > 1."""
        built = self._built_step(per_group_batch)
        if built.mode != "spmd" or built.idle:
            return T.tree_map(lambda _: None, params)
        return built.fn.shard_layout(params)

    # ------------------------------------------------------------------
    # per-round step and whole runs
    # ------------------------------------------------------------------

    def _annotate_buckets(self, built, params) -> None:
        """Once per built step: an ``exchange.bucket`` instant per gradient
        slab of the SPMD exchange (bytes, leaf count, head-ness), so the
        trace shows the layout the step gathers in."""
        if not self.tracer.enabled or getattr(built, "buckets_annotated",
                                              False):
            return
        built.buckets_annotated = True
        if built.mode != "spmd" or built.idle or self.bucket_bytes <= 0:
            return
        from repro_torch.core.async_sgd import head_mask_tree
        from repro_torch.engine.buckets import assign_buckets
        local = built.shard(params)
        mask = T.leaves(head_mask_tree(local, self.head_filter))
        for i, b in enumerate(assign_buckets(T.leaves(local), mask,
                                             self.bucket_bytes)):
            self.tracer.instant("exchange.bucket", bucket=i,
                                bytes=b.nbytes, leaves=len(b.indices),
                                dtype=b.dtype, head=b.is_head)

    def _past_mesh(self, built) -> bool:
        """Whether some ranks of the world lie outside the step's mesh."""
        return (built.mode == "spmd"
                and rank_and_world()[1] > built.g * built.k * self.mp)

    @staticmethod
    def _from_rank0(p, v, extra):
        """Rank 0's full trees ``p``, ``v`` and picklable ``extra`` on
        every rank (one broadcast a leaf): the ranks past the mesh ran no
        round."""
        import torch.distributed as dist
        n = len(T.leaves(p))
        flat = [t.contiguous() for t in T.leaves(p) + T.leaves(v)]
        for t in flat:
            dist.broadcast(t, src=0)
        box = [extra]
        dist.broadcast_object_list(box, src=0)
        return T.unflatten(p, flat[:n]), T.unflatten(v, flat[n:]), box[0]

    def _record_losses(self, built, loss) -> float:
        if built.mode != "vmap":
            self.shard_losses.append(np.asarray(loss.detach().cpu()))
        return built.scalar_loss(loss)

    def step(self, params, mom, batch):
        """One timed round on the global ``batch`` (a dict of device
        tensors with leaves (B, ...), B divisible by g or the sum of
        ``micro_sizes``). Returns
        ``(params, mom, loss)`` (new full trees; the caller's are not
        changed; ``loss`` a 0-d tensor under vmap, else the float64 mean
        of the per-shard losses); the wall time, which ends in the
        synchronizing loss read, lands in telemetry."""
        built = self._round_step(T.leaves(batch)[0].shape[0])
        self._annotate_buckets(built, params)
        with self.tracer.span("engine.step", g=self.num_groups,
                              mode=built.mode):
            t0 = timing.monotonic()
            if built.idle:
                # past the mesh: no round; rank 0's result comes below
                p = T.tree_map(lambda t: t.clone(), params)
                v = T.tree_map(lambda t: t.clone(), mom)
                value = shard = None
            else:
                local = built.local(batch)
                if built.mode == "spmd":
                    # a tensor of its own, as ``run``'s copy gives the shard
                    local = T.tree_map(lambda x: x.clone(), local)
                p, v, loss = built(built.shard(params), built.shard(mom),
                                   local)
                value = self._record_losses(built, loss)
                p, v = built.unshard(p), built.unshard(v)
                shard = self.shard_losses[-1] if built.mode != "vmap" \
                    else None
            if self._past_mesh(built):
                p, v, (value, shard) = self._from_rank0(p, v, (value, shard))
                if built.idle:
                    self.shard_losses.append(shard)
            self.telemetry.record(step_s=timing.monotonic() - t0)
        return p, v, (loss if built.mode == "vmap" else np.float64(value))

    def run(self, params, mom, batches: Iterable, *, steps: int,
            log_every: int = 0, log: Callable = print):
        """Drive ``steps`` rounds from an iterator of host (numpy) global
        batches with prefetch onto the device (under spmd: this rank's
        shard only), telemetry and checkpoint hooks. The caller's
        ``params`` / ``mom`` (full trees) are copied onto the device first
        and never changed. Returns ``(params, mom, losses)`` (full trees;
        losses: Python floats). Under ``"trace-replay"`` the iterator
        supplies one batch per trace commit (``replay``)."""
        if self.strategy.name == "trace-replay":
            return self._run_replay(params, batches, steps=steps,
                                    log_every=log_every, log=log)
        params = T.tree_map(
            lambda t: t.detach().to(self.device, copy=True), params)
        mom = T.tree_map(lambda t: t.detach().to(self.device, copy=True), mom)
        tracer = self.tracer
        losses = []
        batches = iter(batches)
        first = next(batches, _END)
        if first is _END or steps < 1:
            return params, mom, losses
        global_b = T.leaves(first)[0].shape[0]
        built = self._round_step(global_b)
        self._annotate_buckets(built, params)

        def local(stream):
            for batch in stream:
                if T.leaves(batch)[0].shape[0] != global_b:
                    raise ValueError(f"batch {T.leaves(batch)[0].shape[0]} "
                                     f"after batches of {global_b}")
                yield built.local(batch)

        params, mom = built.shard(params), built.shard(mom)
        loss_series = self.telemetry.registry.series("loss")
        n_shard = len(self.shard_losses)
        # a rank past the mesh runs no round: rank 0's results come below
        it = iter(()) if built.idle else prefetch(
            local(itertools.chain([first], batches)), depth=PREFETCH_DEPTH,
            tracer=tracer, metrics=self.telemetry.registry,
            device=self.device)
        with tracer.span("engine.run", strategy=self.strategy.name,
                         g=self.num_groups, steps=steps):
            t_prev = timing.monotonic()
            for i in range(steps):
                with tracer.span("engine.data_wait", step=i):
                    batch = next(it, _END)
                if batch is _END:
                    break
                t_ready = timing.monotonic()
                with tracer.span("engine.step", step=i, mode=built.mode):
                    with tracer.span("engine.dispatch"):
                        params, mom, loss = built(params, mom, batch)
                    # the JAX span's name (docs/observability.md): the
                    # step wall ends in this synchronizing loss read
                    with tracer.span("engine.block_until_ready"):
                        losses.append(self._record_losses(built, loss))
                t_done = timing.monotonic()
                self.telemetry.record(step_s=t_done - t_ready,
                                      data_s=t_ready - t_prev)
                loss_series.append(losses[-1], step=i)
                t_prev = t_done
                if log_every and i % log_every == 0:
                    log(f"step {i:5d} loss {losses[-1]:.4f} "
                        f"({(t_done - t_ready) * 1e3:.0f} ms/it)")
                self._maybe_checkpoint(i + 1, built, params, mom)
        params, mom = built.unshard(params), built.unshard(mom)
        if self._past_mesh(built):
            params, mom, (losses, shard) = self._from_rank0(
                params, mom, (losses, self.shard_losses[n_shard:]))
            self.shard_losses[n_shard:] = shard
        return params, mom, losses

    def replay(self, params, batches, *, steps: Optional[int] = None):
        """Execute the engine's trace along already-stacked ``batches``
        (device tensors with leaves (T, ...), one batch per commit), the
        trace truncated to ``steps`` commits if given. Returns
        ``(final_params, losses (T,) numpy)``; the wall time (ending in
        the losses' copy to the host) lands in telemetry, with the
        ``staleness`` series, the ``replay_max_staleness`` gauge and the
        ``replay_commits`` counter."""
        trace = self.trace
        if trace is None:
            raise ValueError("strategy 'trace-replay' needs Engine(trace=...)")
        if steps is not None:
            trace = trace.truncate(steps)
        if len(trace) == 0:
            raise ValueError("trace has no commits to replay "
                             f"(after truncation to {steps})")
        # the per-commit read-to-commit distance the replay executes
        reg = self.telemetry.registry
        stale = reg.series("staleness")
        for t, s in enumerate(trace.staleness):
            stale.append(float(s), step=t)
        reg.gauge("replay_max_staleness").set(trace.max_staleness)
        reg.counter("replay_commits").inc(len(trace))
        with self.tracer.span("engine.replay", commits=len(trace),
                              impl=self.replay_impl,
                              num_groups=trace.num_groups):
            t0 = timing.monotonic()
            final, losses, _ = self.strategy.replay(self, params, batches,
                                                    trace=trace)
            self.telemetry.record(step_s=timing.monotonic() - t0)
        return final, np.asarray(losses)

    def _run_replay(self, params, batches, *, steps, log_every, log):
        """``run`` under ``"trace-replay"``: the first min(steps, commits)
        host batches stacked onto the device, then ``replay``. Momentum
        starts at zero (the replay owns it) and the returned ``mom`` is
        zeros."""
        if self.trace is None:
            raise ValueError("strategy 'trace-replay' needs Engine(trace=...)")
        n = min(steps, len(self.trace))
        if n == 0:
            raise ValueError("trace has no commits to replay "
                             f"(after truncation to {steps})")
        collected = list(itertools.islice(iter(batches), n))
        if len(collected) < n:
            raise ValueError(f"trace has {n} commits but the batch stream "
                             f"ended after {len(collected)}")
        stacked = self._on_device(T.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]), *collected))
        params = T.tree_map(lambda t: t.detach().to(self.device), params)
        final, losses = self.replay(params, stacked, steps=n)
        dt = self.telemetry.step_s[-1]
        if log_every:
            for i in range(0, n, log_every):
                log(f"commit {i:5d} loss {float(losses[i]):.4f}")
            log(f"replayed {n} commits in {dt:.2f}s "
                f"({dt / n * 1e3:.0f} ms/commit, impl={self.replay_impl})")
        return (final, T.tree_map(torch.zeros_like, final),
                [float(x) for x in losses])

    def _maybe_checkpoint(self, step_no: int, built, params, mom) -> None:
        if not self.checkpoint_dir or not self.checkpoint_every:
            return
        if step_no % self.checkpoint_every:
            return
        with self.tracer.span("engine.checkpoint", step=step_no):
            # the full trees: a gather over "mp" every rank joins
            tree = {"params": built.unshard(params),
                    "mom": built.unshard(mom)}
            if rank_and_world()[0] == 0:
                from repro_torch.checkpoint import checkpointing as CK
                CK.save(f"{self.checkpoint_dir}/ckpt_{step_no:07d}", tree,
                        step=step_no)
        self.telemetry.registry.counter("checkpoints").inc()

    # ------------------------------------------------------------------
    # Algorithm-1 Runner protocol
    # ------------------------------------------------------------------

    def _stream(self, t0: int, probe: bool) -> torch.Generator:
        """The Runner's batch stream at ``state = (params, t0)``: a
        generator on the engine's device seeded from ``(seed, t0 +
        probe)``, so every probe from one state draws the same batches
        and no probe moves the stream (paper App. E-C)."""
        seq = np.random.SeedSequence((int(self.seed), int(t0) + int(probe)))
        seed = int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _on_device(self, tree):
        """A batch tree of tensors or host arrays on the engine's device."""
        return T.tree_map(
            lambda x: (x if isinstance(x, torch.Tensor)
                       else torch.from_numpy(np.array(x))).to(self.device),
            tree)

    def __call__(self, state, *, g: int, mu: float, eta: float, steps: int,
                 probe: bool) -> Tuple[object, np.ndarray]:
        """``Runner`` protocol (``core.auto_optimizer``): run ``steps`` at
        (g, mu, eta) from ``state = (params, step_counter)`` and zero
        momentum. Probe runs restart from the same state and do not
        advance the stream (paper App E-C). Returns ``(state, losses)``:
        the caller's state on a probe, else ``(params, t0 + steps)``;
        ``losses`` (steps,) numpy."""
        if not self.strategy.supports_runner:
            raise ValueError(
                f"strategy {self.strategy.name!r} is not a Runner substrate")
        if self.sample_batches is None or self.batch_size is None:
            raise ValueError("the Runner protocol needs Engine("
                             "sample_batches=..., batch_size=...)")
        params, t0 = state
        batches = self._on_device(self.sample_batches(
            self._stream(t0, probe), steps, self.batch_size))
        params = T.tree_map(lambda t: t.detach().to(self.device), params)
        final, losses = self.strategy.run_stacked(
            self, params, batches, g=g, lr=eta, momentum=mu)
        if probe:
            return state, losses
        return (final, t0 + steps), losses

    # ------------------------------------------------------------------
    # the cluster subsystem's black-box probe
    # ------------------------------------------------------------------

    def profile(self, params, mom, batch, *, warmup: int = 1,
                iters: int = 5) -> float:
        """Black-box examples/s of the engine's own step on one global
        ``batch`` (the cluster subsystem's ``profile_device`` contract,
        synchronizing the engine's device around each timed round): the
        probe never looks inside the step. The step writes new tensors, so
        re-calling it on the same ``params`` / ``mom`` changes nothing."""
        from repro_torch.cluster.devices import profile_device   # lazy
        batch = self._on_device(batch)
        b = T.leaves(batch)[0].shape[0]
        built = self._round_step(b)
        if built.idle:
            raise ValueError("profile needs a rank inside the group mesh")
        local = built.local(batch)
        args = (built.shard(params), built.shard(mom), local)
        return profile_device(built, args, batch_size=b, warmup=warmup,
                              iters=iters, device=self.device)

    def profiled_spec(self, spec, params, mom, batch, **kw):
        """``DeviceSpec`` with its throughput measured from this engine."""
        return dataclasses.replace(
            spec, throughput=self.profile(params, mom, batch, **kw))
