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

The Algorithm-1 Runner protocol and ``profile`` (ROADMAP item 14), the
heterogeneous planner's per-group weights and batch sizes (item 14) and
trace replay (item 13) are not ported yet.
"""
from __future__ import annotations

import itertools
from typing import Callable, Iterable, Optional

import numpy as np

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
    """

    def __init__(self, loss_fn: Callable, *, strategy: str = "grouped-fused",
                 num_groups: int = 1, lr: float = 0.02, momentum: float = 0.0,
                 weight_decay: float = 0.0,
                 head_filter: Optional[Callable] = None,
                 update_impl: str = "cuda", exec_mode: str = "vmap",
                 num_devices: Optional[int] = None, mp: int = 1,
                 sharding_rules=None,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
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

    def _built_step(self, per_group_batch: int):
        step = self._steps.get(per_group_batch)
        if step is None:
            step = self.strategy.build_step(
                self, g=self.num_groups, lr=self.lr, momentum=self.momentum,
                per_group_batch=per_group_batch)
            self._steps[per_group_batch] = step
        return step

    def _per_group_batch(self, global_batch: int) -> int:
        if global_batch % self.num_groups:
            raise ValueError(f"batch {global_batch} not divisible by "
                             f"g={self.num_groups}")
        return global_batch // self.num_groups

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
        tensors with leaves (B, ...), B divisible by g). Returns
        ``(params, mom, loss)`` (new full trees; the caller's are not
        changed; ``loss`` a 0-d tensor under vmap, else the float64 mean
        of the per-shard losses); the wall time, which ends in the
        synchronizing loss read, lands in telemetry."""
        b = T.leaves(batch)[0].shape[0]
        built = self._built_step(self._per_group_batch(b))
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
        losses: Python floats)."""
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
        built = self._built_step(self._per_group_batch(global_b))
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
                    with tracer.span("engine.sync"):
                        # step wall ends in this read
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
