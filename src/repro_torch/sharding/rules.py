"""Parameter sharding specs for the engine's model-parallel storage (the
engine's part of the JAX package's ``sharding/rules.py``).

A spec is a plain tuple with one entry per dim: ``None`` (replicated) or
the mesh axis that shards it. Written as a tuple, it is the same value as
the JAX ``PartitionSpec`` of the same leaf. A mesh is anything with axis
sizes by name: a ``torch.distributed`` ``DeviceMesh`` with dim names
(``launch.mesh.make_group_mesh``) or a mapping such as
``{"group": 2, "data": 1, "mp": 2}``.

``engine_param_specs`` picks, per leaf, first match wins: an explicit
``(regex-path-window, spec)`` rule; the ``TENSOR_PREF`` name table via
``param_spec``; else ``auto_spec``'s trailing-most divisible body dim.

The JAX package's GSPMD helpers (``params_shardings``,
``batch_shardings``, ``cache_shardings``, the ``constrain_*`` family) serve
its XLA dry-run lowering and have no counterpart here (ROADMAP, beside the
XLA-HLO tooling).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core import tree as T

Spec = Tuple[Optional[object], ...]

# preferred tensor-sharded dim (by trailing param name), tried in order
TENSOR_PREF: Dict[str, Tuple[int, ...]] = {
    "wq": (1,), "wk": (1,), "wv": (1,), "wo": (0,),
    "bq": (0,), "bk": (0,), "bv": (0,),
    "w_gate": (-1, 0), "w_up": (-1, 0), "w_down": (-2, -1),
    "tok": (0, 1), "unembed": (1, 0),
    "router": (1,),
    "in_proj": (1,), "out_proj": (0,),
    "w_gate_branch": (1,), "w_rec_in": (1,), "w_a": (1,), "w_x": (1,),
    "w_out": (0,),
    "w": (3, 0),     # CNN conv kernels (HWIO): shard Cout
    "b": (0,),
}


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis sizes by name of a ``DeviceMesh`` or a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    raise TypeError(f"not a mesh: {mesh!r}")


def _axis_size(shape: Mapping[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(shape[a] for a in axes)


def default_axes(mesh) -> Tuple[Optional[str], Tuple[str, ...]]:
    """(tensor_axis, fsdp_axes) resolved from the mesh's axis names: the
    tensor axis is "model" when present, else "mp", else None; the fsdp
    axes are whichever of ("pod", "data") the mesh carries. A "group" axis
    is never used: the grouped update needs params replicated over
    groups."""
    shape = mesh_axes(mesh)
    if "model" in shape:
        tensor = "model"
    elif "mp" in shape:
        tensor = "mp"
    else:
        tensor = None
    return tensor, tuple(a for a in ("pod", "data") if a in shape)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def param_spec(path, shape: Tuple[int, ...], mesh, *,
               tensor_axis: Optional[str] = "model",
               num_stack_dims: int = 0) -> Spec:
    """Spec for one param leaf over the tensor axis (the JAX function with
    no fsdp axes, as the engine calls it). ``num_stack_dims`` marks
    leading stacking dims (layers) that must stay unsharded.
    ``tensor_axis=None`` disables tensor sharding."""
    name = _leaf_name(path)
    ndim = len(shape)
    tsize = _axis_size(mesh_axes(mesh), tensor_axis)
    body = list(range(num_stack_dims, ndim))

    # 1-D body params (norm scales, biases) are tiny: replicate
    if len(body) <= 1 and name not in ("tok",):
        return (None,) * ndim

    def norm(d):
        # TENSOR_PREF indices are relative to the unstacked layout
        return (d + num_stack_dims) if d >= 0 else ndim + d

    # attention (and recurrence) weights are strict: the preferred
    # (head/channel) dim or nothing, never the contraction dim
    strict = name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv",
                      "w_a", "w_x", "conv_w", "conv_b")
    prefs = [norm(d) for d in TENSOR_PREF.get(name, ())]
    if not strict:
        prefs += sorted(body, key=lambda d: -shape[d])
    if tsize > 1:
        for d in prefs:
            if d in body and shape[d] % tsize == 0 and shape[d] >= tsize:
                return tuple(tensor_axis if i == d else None
                             for i in range(ndim))
    return (None,) * ndim


def _stack_dims(path) -> int:
    """Leading stacking dims of a param leaf, from its tree path."""
    keys = list(path)
    if "blocks" in keys or "enc" in keys or "rem" in keys:
        return 1
    if "super" in keys:
        # hybrid "rec" and vlm "self" carry (n_super, per) stacking
        return 2 if ("rec" in keys or "self" in keys) else 1
    return 0


def _path_keys(path) -> Tuple[str, ...]:
    """Tree path -> string keys (dict keys and list indices alike), the
    match target of explicit rules."""
    return tuple(str(e) for e in path)


def _match_rule(patterns: Sequence[str], keys: Sequence[str]) -> bool:
    """True if ``patterns`` (regexes, full-match each) match any
    contiguous window of ``keys``."""
    pats = tuple(re.compile(p + r"$") for p in patterns)
    for i in range(len(keys) - len(pats) + 1):
        window = keys[i:i + len(pats)]
        if all(p.match(k) for p, k in zip(pats, window)):
            return True
    return False


def auto_spec(shape: Tuple[int, ...], size: int, *, axis: str,
              num_stack_dims: int = 0) -> Spec:
    """Spec for a leaf no rule or table entry matches: shard the
    trailing-most body dim divisible by ``size``; 1-D bodies (and leaves
    with no divisible dim) replicate."""
    ndim = len(shape)
    body = list(range(num_stack_dims, ndim))
    if size <= 1 or len(body) <= 1:
        return (None,) * ndim
    for d in reversed(body):
        if shape[d] % size == 0 and shape[d] >= size:
            return tuple(axis if i == d else None for i in range(ndim))
    return (None,) * ndim


def engine_param_specs(params, mesh, *, rules=None, mp_axis=None):
    """Spec tree for the engine's model-parallel param/momentum storage.
    Only the mesh's model-parallel axis is ever used: "group" and "data"
    stay replicated because the grouped update runs identically on every
    worker. ``params`` leaves need only ``.shape``. Every spec divides its
    leaf's shape (explicit rules are checked here)."""
    mshape = mesh_axes(mesh)
    if mp_axis is None:
        mp_axis = default_axes(mshape)[0]
    size = int(mshape[mp_axis]) if mp_axis is not None else 1
    rules = tuple(rules or ())

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if size > 1:
            keys = _path_keys(path)
            for patterns, spec in rules:
                if _match_rule(patterns, keys):
                    spec = tuple(spec)
                    for d, ax in enumerate(spec):
                        if ax is None:
                            continue
                        s = _axis_size(mshape, ax)
                        if d >= len(shape) or shape[d] % s:
                            raise ValueError(
                                f"rule {patterns} gives spec {spec} which "
                                f"does not divide leaf {keys} of shape "
                                f"{shape}")
                    return spec
        nsd = _stack_dims(path)
        if _leaf_name(path) in TENSOR_PREF:
            return param_spec(path, shape, mshape, tensor_axis=mp_axis,
                              num_stack_dims=nsd)
        return auto_spec(shape, size, axis=mp_axis, num_stack_dims=nsd)

    return T.tree_map_with_path(one, params)


def spec_mp_dim(spec: Spec, axis: str) -> Optional[int]:
    """Dim index ``axis`` shards in ``spec`` (None when replicated)."""
    for d, ax in enumerate(spec):
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return d
    return None
