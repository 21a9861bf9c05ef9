"""The grouped training round, written as the sequence it stands for.

Paper Fig. 17(b) with the merged-FC head: every group's gradient is taken
at the round-start parameters on its contiguous slice of the batch; then,
one group after another, the backbone parameters take a momentum-SGD
sub-step with that group's gradient, and once a round the head parameters
take one sub-step with the groups' mean gradient:
``V = mu V - eta grad; W = W + V``. Not the closed form the program
applies: its sub-steps one by one, in float32.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from reference.precision import exact_fp32


def flatten(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in flatten(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in flatten(v, path + (i,))]
    return [(path, tree)]


def rebuild(like, flat: List[torch.Tensor]):
    """``like``'s structure with the leaves of ``flat``, in order."""
    return _rebuild(like, iter(flat))


def _rebuild(node, it):
    if isinstance(node, dict):
        return {k: _rebuild(v, it) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, it) for v in node)
    return next(it)


def grouped_round(params, mom, batch: Dict[str, torch.Tensor],
                  loss: Callable, *, groups: int, lr: float, momentum: float,
                  is_head: Callable = lambda path: False,
                  batch_fraction: float = 1.0, own_group: int = -1):
    """One round. ``loss(params, batch) -> scalar``. Returns ``(params,
    mom, mean of the groups' losses, per-leaf mean over the groups of the
    gradients' norms)``; the inputs are not changed. ``batch_fraction`` < 1
    keeps only the first part of each group's slice; ``own_group`` >= 0
    uses that group's gradient for every group, as a rank that exchanged
    nothing would (faults planted to see the comparison catch them)."""
    leaves = flatten(params)
    paths = [p for p, _ in leaves]
    w0 = [t.detach().float() for _, t in leaves]
    w = [t.clone() for t in w0]
    v = [t.detach().float().clone() for _, t in flatten(mom)]
    head = [bool(is_head(p)) for p in paths]
    head_sum = [torch.zeros_like(t) if h else None for t, h in zip(w0, head)]
    n = next(iter(batch.values())).shape[0]
    per = n // groups
    keep = max(1, int(round(per * batch_fraction)))
    losses, gnorm = [], [0.0] * len(w0)
    with exact_fp32():
        for i in range(groups):
            xs = [t.requires_grad_(True) for t in
                  (x.detach() for x in w0)]
            j0 = i if own_group < 0 else own_group
            sl = slice(j0 * per, j0 * per + keep)
            with torch.enable_grad():
                value = loss(rebuild(params, xs),
                             {k: b[sl] for k, b in batch.items()})
                grads = torch.autograd.grad(value, xs)
            losses.append(float(value.detach()))
            for j, g in enumerate(grads):
                gnorm[j] += float(torch.linalg.vector_norm(
                    g, dtype=torch.float64)) / groups
                if head[j]:
                    head_sum[j] += g
                else:
                    v[j].mul_(momentum).sub_(lr * g)
                    w[j].add_(v[j])
            del grads, xs
    for j in range(len(w)):
        if head[j]:
            v[j].mul_(momentum).sub_(lr * head_sum[j] / groups)
            w[j].add_(v[j])
    return (rebuild(params, w), rebuild(params, v), sum(losses) / groups,
            dict(zip(paths, gnorm)))
