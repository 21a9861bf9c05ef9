"""The grouped step across ranks: the paper's compute groups as real
processes (the JAX package's ``engine/spmd.py`` on ``torch.distributed``).

The mesh is a ("group", "data", "mp") split of the world
(``launch.mesh.make_group_mesh``): g groups of k workers of mp ranks each.
Every rank takes the gradient of its own (group, data) shard of the global
batch with ``torch.autograd.grad``; a group's gradient is the mean of its k
shard gradients (synchronous data parallelism within a group), and the
round-robin staleness-0..g-1 grouped update across groups is applied on
every rank alike, so the parameters never diverge.

Reproducibility contract: ranks combine with ``all_gather`` and a *local*
mean, never an all-reduce. An all-reduce's grouping of the sum is the
backend's choice and does not match a single-process reduction; a gather
moves bits unchanged, and the local mean is then the very reduction the
single-process twin performs. So the step is **bitwise**
``make_reference_grouped_step`` at every ``bucket_bytes`` and mp.

Overlapped bucketed exchange (``bucket_bytes > 0``, the default): the
gradient leaves are cut into flat slabs (``engine.buckets``). A hook on
each leaf that ``autograd.grad`` differentiates files its gradient; when a
bucket's last leaf arrives, the hook packs the slab and starts its
``all_gather`` over "data" (``async_op=True``), so the exchange runs while
the backward pass goes on. After the backward pass each slab's data mean is
gathered over "group" into the (g, n) stack, and the closed-form update
runs in the bucket's epilogue through ``fused_bucket_update`` on the slab
(the fused-update kernel, B1, on the card). ``bucket_bytes = 0`` keeps the
whole-tree arm: gathers per leaf after the full backward pass.

Model-parallel storage (``mp > 1``): parameters and momentum are stored as
shards per ``sharding.rules.engine_param_specs``. Each rank gathers the
full leaves from the mp shards (concatenation along the spec's dim: pure
data movement), computes on its microbatch, and slices its gradient back
to its own shard before the exchange; the update is elementwise, so the
updated shard is bitwise the shard of the full update.

The JAX step's donation tie (``_donation_tie``) has no counterpart: it
exists for XLA's copy insertion, and this step writes new tensors.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import tree as T
from repro_torch.core.async_sgd import (apply_grouped_update, head_mask_tree,
                                        value_and_grad)
from repro_torch.engine.buckets import assign_buckets, pack_bucket, unpack_bucket
from repro_torch.kernels.fused_update.ops import fused_bucket_update
from repro_torch.optim.closed_form import grouped_coeffs, head_coeffs
from repro_torch.sharding.rules import engine_param_specs, mesh_axes, spec_mp_dim

#: default per-bucket slab size target (bytes) of the overlapped exchange;
#: 0 selects the whole-tree arm
DEFAULT_BUCKET_BYTES = 4 << 20


#: bytes of the per-shard loss each rank gathers (``SpmdStep._losses``):
#: the loss functions the engine runs return an fp32 scalar
LOSS_BYTES = 4


@dataclasses.dataclass
class ExchangeBytes:
    """One rank's exchange in one ``SpmdStep`` round. A gather of an
    n-byte tensor over an s-rank group makes each rank send its n bytes
    to, and receive n bytes from, each of the s - 1 others (a ring
    forwards the same volume): ``sent = received = (s - 1)·n``."""
    sent: int
    received: int
    gathers: int                   # ``all_gather`` calls, size-1 groups too
    by_axis: Dict[str, int]        # mesh axis -> bytes received over it


def exchange_bytes(params, layout, *, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                   rules=None, head_filter: Optional[Callable] = None
                   ) -> ExchangeBytes:
    """The gathers one ``SpmdStep`` round makes on each rank of a
    ``{"group": g, "data": k, "mp": mp}`` layout, reckoned from the full
    parameter tree's shapes and dtypes (meta tensors do): at mp > 1 the
    gather of each mp-sharded leaf over "mp" (the step's ``unshard`` of its
    storage); per bucket of the local gradient shards (``assign_buckets``,
    with ``head_filter``'s head flags), or per leaf when ``bucket_bytes``
    is 0, a gather over "data" and one of the data mean over "group"; and
    the per-shard losses, gathered over "data" then "group". No process
    group is needed."""
    axes = mesh_axes(layout)
    g, k, mp = axes["group"], axes["data"], axes["mp"]
    flat = T.leaves(params)
    if mp > 1:
        dims = [spec_mp_dim(sp, "mp") for sp in
                T.leaves(engine_param_specs(params, axes, rules=rules))]
    else:
        dims = [None] * len(flat)
    local = [torch.empty(tuple(x.shape[:d]) + (x.shape[d] // mp,)
                         + tuple(x.shape[d + 1:]), dtype=x.dtype,
                         device="meta") if d is not None else x
             for x, d in zip(flat, dims)]
    nbytes = [math.prod(x.shape) * x.element_size() for x in local]
    calls = [(n, "mp", mp) for n, d in zip(nbytes, dims) if d is not None]
    if bucket_bytes > 0:
        heads = T.leaves(head_mask_tree(params, head_filter))
        units = [b.nbytes for b in assign_buckets(local, heads, bucket_bytes)]
    else:
        units = nbytes
    for n in units:
        calls += [(n, "data", k), (n, "group", g)]
    calls += [(LOSS_BYTES, "data", k), (LOSS_BYTES * k, "group", g)]
    by_axis = dict.fromkeys(("group", "data", "mp"), 0)
    for n, axis, size in calls:
        by_axis[axis] += (size - 1) * n
    total = sum(by_axis.values())
    return ExchangeBytes(sent=total, received=total, gathers=len(calls),
                         by_axis=by_axis)


class StrandedDevicesWarning(UserWarning):
    """The chosen within-group width k leaves device slots idle because
    nothing larger divides the per-group microbatch."""


def choose_data_parallel(per_group_batch: int, max_k: int, *,
                         warn: bool = True) -> int:
    """Largest within-group data-parallel width k <= max_k that divides the
    per-group microbatch; k = 1 when nothing divides. Any k < max_k
    strands ``max_k - k`` device slots per group, which is warned here
    (``StrandedDevicesWarning``)."""
    if per_group_batch < 1 or max_k < 1:
        return 1
    k = 1
    for cand in range(min(max_k, per_group_batch), 0, -1):
        if per_group_batch % cand == 0:
            k = cand
            break
    if warn and k < max_k:
        warnings.warn(StrandedDevicesWarning(
            f"per-group batch {per_group_batch} admits data-parallel "
            f"width k={k} < {max_k}: {max_k - k} device slot(s) per group "
            "stranded (pick a batch divisible by the per-group device "
            "count to use the full mesh)"), stacklevel=2)
    return k


def device_batch_split(group_batch, k: int):
    """(g, b, ...) leaves -> (g, k, b/k, ...): one shard per worker."""
    def split(x):
        g, b = x.shape[0], x.shape[1]
        if b % k:
            raise ValueError(f"per-group batch {b} not divisible by k={k}")
        return x.reshape(g, k, b // k, *x.shape[2:])
    return T.tree_map(split, group_batch)


class _Gather:
    """``all_gather`` of one tensor over one process group, started at
    construction; ``wait()`` returns the (n, ...) stack of the parts in
    rank order (pure data movement)."""

    def __init__(self, t: torch.Tensor, group, size: int,
                 async_op: bool = True):
        import torch.distributed as dist
        self.parts = [torch.empty_like(t) for _ in range(size)]
        self.work = dist.all_gather(self.parts, t, group=group,
                                    async_op=async_op)

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return torch.stack(self.parts)


class SpmdStep:
    """One rank's grouped step over a (g, k, mp) group mesh
    (``make_spmd_grouped_step``).

    ``step(params, mom, local_batch) -> (params, mom, losses)``: ``params``
    and ``mom`` are this rank's storage (the full trees at mp = 1, the
    shards of ``shard`` at mp > 1), ``local_batch`` this rank's
    (group, data) shard of the global batch, and ``losses`` the (g, k)
    per-shard losses, the same on every rank. ``shard`` / ``unshard`` move
    full trees to this rank's storage and back (identities at mp = 1)."""

    def __init__(self, loss_fn: Callable, mesh, *, lr: float,
                 momentum: float, weight_decay: float = 0.0,
                 strategy: str = "fused",
                 head_filter: Optional[Callable] = None,
                 group_weights: Optional[Sequence[float]] = None,
                 update_impl: str = "torch",
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 sharding_rules=None):
        if strategy not in ("fused", "scan"):
            raise ValueError(f"unknown strategy {strategy!r}")
        axes = mesh_axes(mesh)
        self.g, self.k, self.mp = axes["group"], axes["data"], axes["mp"]
        self.mesh = mesh
        self.groups = {a: mesh.get_group(a) for a in axes}
        self.mp_index = mesh.get_local_rank("mp")
        self.coord = (mesh.get_local_rank("group"),
                      mesh.get_local_rank("data"), self.mp_index)
        self.loss_fn, self.strategy = loss_fn, strategy
        self.update = dict(lr=lr, momentum=momentum,
                           weight_decay=weight_decay,
                           group_weights=group_weights,
                           update_impl=update_impl)
        self.head_filter = head_filter
        self.bucket_bytes = int(bucket_bytes)
        self.sharding_rules = sharding_rules
        self.coeffs = grouped_coeffs(self.g, lr=lr, momentum=momentum,
                                     weight_decay=weight_decay,
                                     group_weights=group_weights)
        self.hcoeffs = head_coeffs(self.g, lr=lr, momentum=momentum,
                                   weight_decay=weight_decay,
                                   group_weights=group_weights)
        self.mp_dims: Optional[List[Optional[int]]] = None
        self.buckets = None
        self.mesh_shape = (self.g, self.k, self.mp)

    # -- mp storage ---------------------------------------------------------

    def _dims(self, full) -> List[Optional[int]]:
        """The mp-sharded dim (or None) of each leaf of a full tree."""
        if self.mp == 1:
            return [None] * len(T.leaves(full))
        specs = engine_param_specs(full, self.mesh, rules=self.sharding_rules)
        return [spec_mp_dim(s, "mp") for s in T.leaves(specs)]

    def _slice(self, t: torch.Tensor, d: Optional[int]) -> torch.Tensor:
        if d is None:
            return t
        size = t.shape[d] // self.mp
        return t.narrow(d, self.mp_index * size, size).contiguous()

    def shard_layout(self, tree):
        """This rank's shard of each leaf of a full tree: ``None``
        (stored whole) or ``(dim, index, count)``, the ``shards`` of
        ``checkpoint.restore``."""
        return T.unflatten(tree, [None if d is None else
                                  (d, self.mp_index, self.mp)
                                  for d in self._dims(tree)])

    def shard(self, tree):
        """A full tree -> this rank's stored shards. The first call fixes
        the layout of the params/momentum storage the step reads."""
        dims = self._dims(tree)
        if self.mp_dims is None:
            self.mp_dims = dims
        return T.unflatten(tree, [self._slice(t, d) for t, d in
                                  zip(T.leaves(tree), dims)])

    def _full(self, t: torch.Tensor, d: Optional[int]) -> torch.Tensor:
        if d is None:
            return t
        parts = _Gather(t.contiguous(), self.groups["mp"], self.mp,
                        async_op=False).parts
        return torch.cat(parts, dim=d)

    def unshard(self, tree):
        """This rank's stored shards -> the full tree (a gather over "mp",
        which every rank of the mp group must call)."""
        if self.mp == 1:
            return tree
        if self.mp_dims is None:
            raise ValueError("unshard before shard: the mp layout comes "
                             "from the full parameter shapes")
        return T.unflatten(tree, [self._full(t, d) for t, d in
                                  zip(T.leaves(tree), self.mp_dims)])

    # -- the step -------------------------------------------------------------

    def __call__(self, params, mom, batch):
        if self.mp > 1 and self.mp_dims is None:
            raise ValueError("mp > 1: call shard() on the full parameters "
                             "first (it fixes the mp layout)")
        dims = self.mp_dims or [None] * len(T.leaves(params))
        flat_p, flat_v = T.leaves(params), T.leaves(mom)
        flat_m = T.leaves(head_mask_tree(params, self.head_filter))
        full = params if self.mp == 1 else T.unflatten(
            params, [self._full(t, d) for t, d in zip(flat_p, dims)])
        if self.bucket_bytes <= 0:
            return self._whole_tree(params, mom, full, batch, dims)
        if self.buckets is None:
            self.buckets = assign_buckets(flat_p, flat_m, self.bucket_bytes)
        buckets = self.buckets
        owner = {i: j for j, b in enumerate(buckets) for i in b.indices}
        left = [len(b.indices) for b in buckets]
        slots: List[Optional[torch.Tensor]] = [None] * len(flat_p)
        data_gathers: List[Optional[_Gather]] = [None] * len(buckets)

        def hook_for(i):
            def hook(grad):
                # this leaf's gradient exists: keep its shard, and start the
                # bucket's gather over "data" once its last leaf is here
                slots[i] = self._slice(grad, dims[i])
                j = owner[i]
                left[j] -= 1
                if left[j] == 0:
                    data_gathers[j] = _Gather(
                        pack_bucket(buckets[j], slots), self.groups["data"],
                        self.k)
            return hook

        loss, _ = value_and_grad(self.loss_fn, full, batch,
                                 hooks=[hook_for(i)
                                        for i in range(len(flat_p))])
        if any(d is None for d in data_gathers):
            raise RuntimeError("a bucket's gradients never all arrived")
        losses = self._losses(loss)
        group_gathers = [_Gather(dg.wait().mean(0), self.groups["group"],
                                 self.g) for dg in data_gathers]
        new_p, new_v = list(flat_p), list(flat_v)
        if self.strategy == "fused":
            for b, gg in zip(buckets, group_gathers):
                # the update in the bucket's epilogue, on the flat slabs
                wn, vn = fused_bucket_update(
                    pack_bucket(b, flat_p), pack_bucket(b, flat_v), gg.wait(),
                    coeffs=self.hcoeffs if b.is_head else self.coeffs,
                    impl=self.update["update_impl"])
                for i, w, v in zip(b.indices, unpack_bucket(b, wn),
                                   unpack_bucket(b, vn)):
                    # fresh tensors, as the per-leaf update gives: the next
                    # round's kernels then see the same layouts as the twin
                    new_p[i], new_v[i] = w.clone(), v.clone()
            return T.unflatten(params, new_p), T.unflatten(mom, new_v), losses
        # scan: buckets only change the gather granularity; reassemble the
        # per-leaf (g, ...) stacks and run the sequential oracle unchanged
        stacks: List[Optional[torch.Tensor]] = [None] * len(flat_p)
        for b, gg in zip(buckets, group_gathers):
            for i, s in zip(b.indices, unpack_bucket(b, gg.wait())):
                stacks[i] = s.contiguous()
        p2, v2 = self._apply(params, T.unflatten(params, stacks), mom)
        return p2, v2, losses

    def _whole_tree(self, params, mom, full, batch, dims):
        """``bucket_bytes = 0``: gather every leaf after the backward
        pass."""
        loss, grads = value_and_grad(self.loss_fn, full, batch)
        losses = self._losses(loss)
        stacks = []
        for gr, d in zip(grads, dims):
            mean = _Gather(self._slice(gr, d).contiguous(),
                           self.groups["data"], self.k).wait().mean(0)
            stacks.append(_Gather(mean, self.groups["group"], self.g).wait())
        p2, v2 = self._apply(params, T.unflatten(params, stacks), mom)
        return p2, v2, losses

    def _apply(self, params, grads, mom):
        return apply_grouped_update(
            params, grads, mom, strategy=self.strategy,
            head_mask=head_mask_tree(params, self.head_filter),
            coeffs=self.coeffs, hcoeffs=self.hcoeffs, **self.update)

    def _losses(self, loss: torch.Tensor) -> torch.Tensor:
        """(g, k) per-shard losses: a gather over "data", then of those k
        over "group" (the mp ranks of a worker hold equal losses)."""
        mine = _Gather(loss.reshape(1), self.groups["data"], self.k).wait()
        return _Gather(mine.reshape(self.k), self.groups["group"],
                       self.g).wait()


def make_spmd_grouped_step(loss_fn: Callable, mesh, *, lr: float,
                           momentum: float, weight_decay: float = 0.0,
                           strategy: str = "fused",
                           head_filter: Optional[Callable] = None,
                           group_weights: Optional[Sequence[float]] = None,
                           update_impl: str = "torch",
                           bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                           sharding_rules=None) -> SpmdStep:
    """Build this rank's ``step(params, mom, local_batch)`` over ``mesh``
    (``SpmdStep``). ``bucket_bytes``: slab size target of the overlapped
    exchange (module doc); 0 selects the whole-tree arm. With mp > 1 the
    buckets pack the local gradient shards. ``sharding_rules``: optional
    explicit ``(regex-path-window, spec)`` rules for
    ``engine_param_specs``."""
    return SpmdStep(loss_fn, mesh, lr=lr, momentum=momentum,
                    weight_decay=weight_decay, strategy=strategy,
                    head_filter=head_filter, group_weights=group_weights,
                    update_impl=update_impl, bucket_bytes=bucket_bytes,
                    sharding_rules=sharding_rules)


def make_reference_grouped_step(loss_fn: Callable, g: int, k: int, *,
                                lr: float, momentum: float,
                                weight_decay: float = 0.0,
                                strategy: str = "fused",
                                head_filter: Optional[Callable] = None,
                                group_weights: Optional[Sequence[float]] = None,
                                update_impl: str = "torch"):
    """The single-process twin of the SPMD step: the same (g, k) shard
    structure run one shard after another, the same means in the same
    tensor layout, the same update. ``step(params, mom, dbatch)`` takes
    the (g, k, b/k, ...) batch of ``device_batch_split`` and returns
    ``(params, mom, losses)``, ``losses`` (g, k). The bitwise target of
    ``make_spmd_grouped_step`` at every ``bucket_bytes`` and mp."""
    coeffs = grouped_coeffs(g, lr=lr, momentum=momentum,
                            weight_decay=weight_decay,
                            group_weights=group_weights)
    hcoeffs = head_coeffs(g, lr=lr, momentum=momentum,
                          weight_decay=weight_decay,
                          group_weights=group_weights)

    def step(params, mom, dbatch):
        losses, means = [], None
        for gi in range(g):
            shard_grads = []
            for ki in range(k):
                shard = T.tree_map(lambda x: x[gi, ki].clone(), dbatch)
                loss, gr = value_and_grad(loss_fn, params, shard)
                losses.append(loss)
                shard_grads.append(gr)
            # a rank's local mean of its gathered (k, ...) stack
            gm = [torch.stack(per).mean(0) for per in zip(*shard_grads)]
            means = [[x] for x in gm] if means is None else [
                m + [x] for m, x in zip(means, gm)]
        grads = T.unflatten(params, [torch.stack(m) for m in means])
        params, mom = apply_grouped_update(
            params, grads, mom, strategy=strategy, lr=lr, momentum=momentum,
            weight_decay=weight_decay,
            head_mask=head_mask_tree(params, head_filter),
            group_weights=group_weights, update_impl=update_impl,
            coeffs=coeffs, hcoeffs=hcoeffs)
        return params, mom, torch.stack(losses).reshape(g, k)

    step.mesh_shape = (g, k)
    return step
