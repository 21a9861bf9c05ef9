"""Seeded weights made on the device in a few large calls.

Every leaf of a parameter tree is a view into one flat buffer per dtype.
Each buffer is filled by ``normal_`` from one ``torch.Generator`` on the
device, a gigaelement at a time, and then each leaf is scaled by its own
standard deviation (zero leaves are zeroed). The same seed gives the same
weights on the same kind of device; the program and the reference are
handed the same tensors.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from harness.common import subseed

CHUNK = 1 << 30          # elements a ``normal_`` call
WEIGHTS_TAG = 101


def fill(specs: Sequence[Tuple[tuple, torch.dtype, float]], seed: int,
         device) -> List[torch.Tensor]:
    """``specs``: (shape, dtype, std) per leaf -> the leaves, in order."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(
        subseed(seed, WEIGHTS_TAG))
    out: List[torch.Tensor] = [None] * len(specs)
    for dtype in sorted({s[1] for s in specs}, key=str):
        idx = [i for i, s in enumerate(specs) if s[1] == dtype]
        sizes = [int(torch.Size(specs[i][0]).numel()) for i in idx]
        buf = torch.empty(sum(sizes), dtype=dtype, device=device)
        for a in range(0, buf.numel(), CHUNK):
            buf[a:a + CHUNK].normal_(generator=gen)
        off = 0
        for i, n in zip(idx, sizes):
            leaf = buf[off:off + n].view(specs[i][0])
            std = specs[i][2]
            if std == 0.0:
                leaf.zero_()
            elif std != 1.0:
                leaf.mul_(std)
            out[i] = leaf
            off += n
    return out


def fill_tree(tree, std_of: Callable[[tuple, torch.Tensor], float],
              seed: int, device, dtype_of: Callable = None):
    """A tree of meta tensors (shapes, dtypes) -> the same tree of seeded
    tensors on ``device``. ``std_of(path, meta)``: each leaf's standard
    deviation; ``dtype_of(path, meta)``: its dtype (default: the meta
    tensor's)."""
    found = leaves_with_paths(tree)
    specs = [(tuple(m.shape),
              dtype_of(p, m) if dtype_of is not None else m.dtype,
              float(std_of(p, m))) for p, m in found]
    return _rebuild(tree, iter(fill(specs, seed, device)))


def _rebuild(node, it):
    if isinstance(node, dict):
        return {k: _rebuild(v, it) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, it) for v in node)
    return next(it)


def leaves_with_paths(tree, path=()):
    """[(path, tensor)] in the tree's order (dict keys as stored)."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves_with_paths(v, path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, path + (i,))
        return out
    return [(path, tree)]


def path_name(path) -> str:
    return ".".join(str(p) for p in path)
