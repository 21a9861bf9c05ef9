"""Checkpointing: tree save/restore (npz) with step metadata (the JAX
package's ``checkpoint/checkpointing.py``). The files are the JAX
package's: a checkpoint either package writes, the other restores.

Naming contract: each leaf's npz key is its tree path, one escaped segment
per path entry (dict key or list index) joined with "/". Segments escape
"\\\\" and "/" (``_escape``), so a dict key containing "/" can never alias
another leaf's name; ``save`` also checks that the names are unique and
raises instead of letting ``np.savez`` keep the last write.

Restore contract: each loaded array lands on the target leaf's device, in
the target's dtype only if it already is that dtype (a mismatch raises
unless ``allow_cast=True``: a silent cast can hide drift between the saved
and the resuming run). Where the engine stores mp shards
(``Engine.shard_layout``), ``shards`` names each leaf's (dim, index,
count) and the leaf receives its own slice of the full saved array.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree as T


def _escape(segment: str) -> str:
    """Escape a path segment so "/" joins cannot alias across segment
    boundaries: backslash first, then the separator itself."""
    return segment.replace("\\", "\\\\").replace("/", "\\/")


def _leaf_names(tree):
    """Escaped path-joined names, one per leaf in flatten order."""
    return ["/".join(_escape(str(p)) for p in path)
            for path, _ in T.leaves_with_path(tree)]


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError:
        raise TypeError(f"{dtype} has no numpy dtype to store in a "
                        "checkpoint") from None


def _flatten_with_names(tree):
    out = {}
    for name, leaf in zip(_leaf_names(tree), T.leaves(tree)):
        if name in out:
            raise ValueError(
                f"checkpoint name collision: two leaves flatten to "
                f"{name!r}; distinct tree paths must produce distinct "
                "names (escaped-path contract, module doc)")
        _numpy_dtype(leaf.dtype)
        out[name] = leaf.detach().cpu().numpy()
    return out


def save(path, tree, *, step: int = 0, extra: Optional[dict] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = _flatten_with_names(tree)
    np.savez(path.with_suffix(".npz"), **arrays)
    meta = {"step": step, "leaves": sorted(arrays), **(extra or {})}
    path.with_suffix(".json").write_text(json.dumps(meta, indent=2))


def restore(path, tree_like, *, allow_cast: bool = False,
            shards=None) -> Tuple[object, int]:
    """Restore into the structure of ``tree_like``. Returns (tree, step).

    Each leaf lands on the ``tree_like`` leaf's device. ``shards``
    (optional, ``tree_like``'s structure) holds ``None`` or a
    ``(dim, index, count)`` per leaf: that leaf is shard ``index`` of
    ``count`` along ``dim`` of the saved array. Dtype mismatches raise
    unless ``allow_cast=True`` (module doc)."""
    path = Path(path)
    data = np.load(path.with_suffix(".npz"))
    meta = json.loads(path.with_suffix(".json").read_text())
    flat = T.leaves(tree_like)
    where = T.leaves(shards) if shards is not None else [None] * len(flat)
    leaves = []
    for name, leaf, part in zip(_leaf_names(tree_like), flat, where):
        arr = data[name]
        if part is not None:
            dim, index, count = part
            size = arr.shape[dim] // count
            arr = np.take(arr, range(index * size, (index + 1) * size),
                          axis=dim)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        want = _numpy_dtype(leaf.dtype)
        if arr.dtype != want:
            if not allow_cast:
                raise ValueError(
                    f"dtype mismatch for {name}: checkpoint has "
                    f"{arr.dtype}, target expects {want} "
                    "(pass allow_cast=True to cast explicitly)")
            arr = arr.astype(want)
        leaves.append(torch.from_numpy(np.ascontiguousarray(arr)).to(
            leaf.device))
    return T.unflatten(tree_like, leaves), int(meta["step"])


def latest(dirpath) -> Optional[Path]:
    d = Path(dirpath)
    if not d.exists():
        return None
    cands = sorted(d.glob("ckpt_*.json"))
    return cands[-1].with_suffix("") if cands else None
