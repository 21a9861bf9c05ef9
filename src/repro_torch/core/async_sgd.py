"""Asynchronous (stale-gradient) SGD with compute groups (the JAX
package's ``core/async_sgd.py``, single device). Two implementations of
the paper's execution strategy:

1. ``delayed_sgd_run`` — the Theorem-1-exact object: SGD where the gradient
   applied at step t was evaluated at ``W_{t-S}`` (S = g-1), from an
   (S+1)-deep ring of parameters. The statistical-efficiency substrate and
   the ``delayed`` strategy behind Algorithm 1's Runner; meant for small
   models.

2. The deployable grouped step: each round, all g groups compute
   gradients at the round-start parameters, then the g updates land with
   staleness 0..g-1 — the paper's Fig. 17(b) round-robin picture.
   ``head_filter`` implements the merged-FC optimization: head params see
   one averaged (zero-staleness) update each round.

Because all g gradients are evaluated at round-start parameters, the g
sequential momentum-SGD sub-steps form a linear recurrence with a
closed-form solution (``optim/closed_form.py``). ``strategy="fused"``
applies that closed form in ONE pass over the parameters
(``kernels/fused_update``); ``strategy="scan"`` keeps the literal O(g)
sequential application as the semantic reference. Both reduce exactly to
synchronous data-parallel SGD at g=1.

Spans (``obs.spans``, free when no tracer is installed): ``round.grad``
(``group``) around one group's forward and backward and ``round.stack``
around the copy of its gradients into the stacks, in
``stacked_group_grads``; ``round.update`` (``g``, ``leaves``, ``impl``)
around the update in ``apply_grouped_update``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import tree as T
from repro_torch.kernels.fused_update.ops import fused_group_update
from repro_torch.obs import spans
from repro_torch.optim.closed_form import (_weight_scales, grouped_coeffs,
                                           head_coeffs)


# ---------------------------------------------------------------------------
# 1. Exact delayed SGD (Theorem-1 semantics), for SE experiments
# ---------------------------------------------------------------------------

def delayed_sgd_run(loss_fn: Callable, params, batches, *, staleness: int,
                    lr: float, momentum: float = 0.0,
                    weight_decay: float = 0.0, record_params: bool = False):
    """Run ``T`` delayed-SGD steps (T = leading dim of every ``batches``
    leaf), one ``torch.autograd.grad`` a step.

    Update:  V_{t+1} = mu V_t - eta grad(W_{t-S});  W_{t+1} = W_t + V_{t+1}.
    For t < S the oldest available parameters are used (cold history:
    every slot of the ring starts at W_0). The caller's ``params`` are not
    changed.

    Returns (final_params, losses (T,) tensor, params_trace or None); the
    trace stacks W_1..W_T along a leading (T, ...) axis per leaf.
    """
    S = int(staleness)
    if S < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    flat = [p.detach() for p in T.leaves(params)]
    # ring of the last S+1 parameter states, slot t % (S+1) holding W_t
    hist = [torch.stack([p] * (S + 1)) for p in flat]
    mom = [torch.zeros_like(p) for p in flat]
    n_steps = T.leaves(batches)[0].shape[0]
    losses, trace = [], []
    for t in range(n_steps):
        # oldest params in the ring = W_{t-S} (clamped during cold history)
        idx = (t - S) % (S + 1) if t >= S else 0
        stale = T.unflatten(params, [h[idx] for h in hist])
        loss, grads = value_and_grad(loss_fn, stale,
                                     T.tree_map(lambda x: x[t], batches))
        nxt = (t + 1) % (S + 1)
        new_flat = []
        for j, (h, gr) in enumerate(zip(hist, grads)):
            cur = h[t % (S + 1)]
            if weight_decay:
                gr = gr + weight_decay * cur
            mom[j] = momentum * mom[j] - lr * gr
            new = cur + mom[j]
            h[nxt] = new          # overwrites W_{t-S}, read above
            new_flat.append(new)
        losses.append(loss)
        if record_params:
            trace.append(new_flat)
    final = T.unflatten(params, [h[n_steps % (S + 1)].clone()
                                 for h in hist])
    stacked = None
    if record_params:
        stacked = T.unflatten(params, [torch.stack(xs)
                                       for xs in zip(*trace)])
    return final, torch.stack(losses), stacked


# ---------------------------------------------------------------------------
# 2. The deployable grouped step
# ---------------------------------------------------------------------------

def scan_grouped_update(params, grads, mom_buf, *, lr: float, momentum: float,
                        weight_decay: float = 0.0, head_mask=None,
                        group_weights: Optional[Sequence[float]] = None):
    """Reference O(g) update application: the literal sequential loop over
    the g sub-steps (plus the merged-FC head update). ``grads`` carries a
    leading (g, ...) group axis per leaf. Returns (params, mom_buf).

    ``group_weights``: group i's gradient is pre-scaled by
    ``g * w_i / sum(w)`` before every use, so the head sees the
    share-weighted average and sub-step i a share-scaled step. Uniform
    weights scale by exactly 1.0 — bitwise the unweighted path.
    """
    g = T.leaves(grads)[0].shape[0]
    if head_mask is None:
        head_mask = T.tree_map(lambda _: False, params)
    scales = _weight_scales(g, group_weights)
    if scales is not None:
        def scale(gr):
            s = torch.tensor(scales, dtype=torch.float32, device=gr.device)
            return gr * s.reshape((g,) + (1,) * (gr.dim() - 1)).to(gr.dtype)
        grads = T.tree_map(scale, grads)

    # merged-FC head: single synchronous (share-weighted) averaged update
    # per round — with pre-scaled gradients the plain mean is that average
    head_grads = T.tree_map(lambda gr: gr.mean(dim=0), grads)

    def upd_leaf(p, gg, v):
        g32 = gg.float()
        if weight_decay:
            g32 = g32 + weight_decay * p.float()
        v_new = momentum * v.float() - lr * g32
        return (p.float() + v_new).to(p.dtype), v_new.to(v.dtype)

    for i in range(g):
        # backbone: apply group-i gradient; head: untouched this sub-step
        new = T.tree_map(
            lambda m, pp, gg, vv: (pp, vv) if m else upd_leaf(pp, gg[i], vv),
            head_mask, params, grads, mom_buf)
        params, mom_buf = T.unzip2(new, head_mask)
    # head update (zero-staleness, merged FC), once per round
    new = T.tree_map(
        lambda m, pp, gg, vv: upd_leaf(pp, gg, vv) if m else (pp, vv),
        head_mask, params, head_grads, mom_buf)
    return T.unzip2(new, head_mask)


def apply_grouped_update(params, grads, mom_buf, *, strategy: str, lr: float,
                         momentum: float, weight_decay: float = 0.0,
                         head_mask=None,
                         group_weights: Optional[Sequence[float]] = None,
                         update_impl: str = "torch",
                         coeffs=None, hcoeffs=None):
    """Apply one round of grouped updates (``grads`` leading axis = g) via
    either strategy — the update-application entry point shared by
    ``make_grouped_train_step`` and the engine. Returns
    ``(params, mom_buf)``. ``coeffs`` / ``hcoeffs`` may be precomputed by
    the caller for the fused path."""
    if strategy not in ("fused", "scan"):
        raise ValueError(f"unknown strategy {strategy!r}")
    attrs = {}
    if spans.current().enabled:
        leaves = T.leaves(grads)
        attrs = dict(g=int(leaves[0].shape[0]), leaves=len(leaves),
                     impl=update_impl if strategy == "fused" else "scan")
    with spans.span("round.update", **attrs):
        if strategy == "scan":
            return scan_grouped_update(
                params, grads, mom_buf, lr=lr, momentum=momentum,
                weight_decay=weight_decay, head_mask=head_mask,
                group_weights=group_weights)
        g = T.leaves(grads)[0].shape[0]
        if coeffs is None:
            coeffs = grouped_coeffs(g, lr=lr, momentum=momentum,
                                    weight_decay=weight_decay,
                                    group_weights=group_weights)
        if hcoeffs is None:
            hcoeffs = head_coeffs(g, lr=lr, momentum=momentum,
                                  weight_decay=weight_decay,
                                  group_weights=group_weights)
        return fused_group_update(params, grads, mom_buf, coeffs=coeffs,
                                  head_coeffs=hcoeffs, head_mask=head_mask,
                                  impl=update_impl)


def value_and_grad(loss_fn: Callable, params, batch, hooks=None):
    """``(loss, [grad of each leaf])`` of ``loss_fn(params, batch)`` at
    detached copies of the leaves, by ``torch.autograd.grad``. ``hooks``:
    optional per-leaf callables, registered on those leaves, that each
    receive the leaf's gradient the moment the backward pass produces it
    (the SPMD step's bucketed exchange starts there)."""
    flat = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    if hooks is not None:
        for x, h in zip(flat, hooks):
            x.register_hook(h)
    with torch.enable_grad():
        loss = loss_fn(T.unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), list(grads)


def accumulated_value_and_grad(loss_fn: Callable, params, batch,
                               grad_accum: int = 1):
    """``value_and_grad`` over ``grad_accum`` microbatches (the leading
    axis of every ``batch`` leaf when ``grad_accum > 1``): fp32 sums of the
    losses and gradients from the first term on (0 + x == x: the JAX
    scan's zero-initialised fp32 carry, without the zeros), each divided
    by ``grad_accum``."""
    if grad_accum == 1:
        return value_and_grad(loss_fn, params, batch)
    total, acc = None, None
    for a in range(grad_accum):
        loss, gr = value_and_grad(loss_fn, params,
                                  T.tree_map(lambda x: x[a], batch))
        if acc is None:
            total, acc = loss, [x.float() for x in gr]
            continue
        total = total + loss
        # leaf by leaf, each old sum dropped as its new one exists (not in
        # place: autograd may hand two leaves one gradient tensor)
        for j in range(len(acc)):
            acc[j], gr[j] = acc[j] + gr[j], None
    for j in range(len(acc)):
        acc[j] = acc[j] / grad_accum
    return total / grad_accum, acc


def stacked_group_grads(grad_fn: Callable, params, batches, g: int):
    """Every group's gradient at the same ``params``, one group at a time:
    ``grad_fn(params, batch_i) -> (loss, [grad of each leaf])`` on
    ``batch_i``, the i-th slice of every ``batches`` leaf. Returns the g
    losses and, per leaf, its ``(g, ...)`` stack. Each leaf's stack is
    allocated when the first group's gradient arrives, and each group's
    gradient is copied into its slot and dropped at once, so g gradient
    copies exist at the peak, not the 2g of stacking kept lists."""
    losses, stacks = [], None
    for i in range(g):
        with spans.span("round.grad", group=i):
            loss, gr = grad_fn(params, T.tree_map(lambda x: x[i], batches))
        losses.append(loss)
        with spans.span("round.stack"):
            if stacks is None:
                stacks = [torch.empty((g,) + tuple(x.shape), dtype=x.dtype,
                                      device=x.device) for x in gr]
            for j in range(len(gr)):
                stacks[j][i].copy_(gr[j])
                gr[j] = None
    return losses, stacks


def head_mask_tree(params, head_filter: Optional[Callable]):
    """Bool tree marking merged-FC head leaves (True) — the mask consumed
    by both update strategies."""
    if head_filter is None:
        return T.tree_map(lambda _: False, params)
    return T.tree_map_with_path(lambda path, _: bool(head_filter(path)),
                                params)


def make_grouped_train_step(loss_fn: Callable, *, num_groups: int, lr: float,
                            momentum: float, weight_decay: float = 0.0,
                            head_filter: Optional[Callable] = None,
                            grad_accum: int = 1, strategy: str = "fused",
                            update_impl: str = "torch",
                            group_weights: Optional[Sequence[float]] = None):
    """Build ``step(params, mom_buf, batches) -> (params, mom_buf, loss)``.

    ``batches``: tree with leading axis ``(g, ...)`` (one microbatch per
    group, see ``group_batch_split``); with grad_accum > 1 the per-group
    batch has a further leading accumulation axis ``(g, A, ...)``.

    Every group's gradient is taken at the round-start parameters: a loop
    over the groups with ``torch.autograd.grad`` stands for the JAX
    ``jax.vmap`` (``torch.func.vmap`` cannot enter an ``autograd.Function``
    whose kernels are called through ``ctypes``), and each leaf's g
    gradients are stacked to ``(g, ...)`` (``stacked_group_grads``).
    ``head_filter(path) -> bool`` marks head ("FC-phase") params:
    merged-FC semantics. ``strategy``:
    "fused" (the closed form in one pass, leaf path ``update_impl``) or
    "scan" (the literal sequential reference). ``group_weights``: per-group
    batch shares.
    """
    if strategy not in ("fused", "scan"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if group_weights is not None:
        group_weights = tuple(float(w) for w in group_weights)
    g = num_groups
    coeffs = grouped_coeffs(g, lr=lr, momentum=momentum,
                            weight_decay=weight_decay,
                            group_weights=group_weights)
    hcoeffs = head_coeffs(g, lr=lr, momentum=momentum,
                          weight_decay=weight_decay,
                          group_weights=group_weights)

    def per_group_grad(params, batch):
        return accumulated_value_and_grad(loss_fn, params, batch,
                                          grad_accum)

    def step(params, mom_buf, batches):
        # all group gradients at round-start params, one group at a time
        losses, stacks = stacked_group_grads(per_group_grad, params,
                                             batches, g)
        grads = T.unflatten(params, stacks)
        params, mom_buf = apply_grouped_update(
            params, grads, mom_buf, strategy=strategy, lr=lr,
            momentum=momentum, weight_decay=weight_decay,
            head_mask=head_mask_tree(params, head_filter),
            group_weights=group_weights, update_impl=update_impl,
            coeffs=coeffs, hcoeffs=hcoeffs)
        return params, mom_buf, torch.stack(losses).mean()

    return step
