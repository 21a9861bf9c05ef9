"""Parameter trees: nested dicts and lists whose leaves are tensors.

The port's stand-in for ``jax.tree``: dicts are walked in sorted-key order
and lists in index order, the order ``jax.tree.leaves`` gives the same
tree, so leaf ``i`` here is leaf ``i`` of the JAX package. Anything that
is not a dict or a list is a leaf (tuples too, so a map may return pairs,
which ``unzip2`` splits)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def _is_node(x) -> bool:
    return isinstance(x, (dict, list))


def leaves(tree) -> List[Any]:
    """The leaves in flatten order."""
    if not _is_node(tree):
        return [tree]
    return [x for _, c in _children(tree) for x in leaves(c)]


def leaves_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in flatten order; a path is the tuple of dict
    keys and list indices from the root."""
    if not _is_node(tree):
        return [(prefix, tree)]
    return [pl for k, c in _children(tree)
            for pl in leaves_with_path(c, prefix + (k,))]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, which must have the same structure (raises otherwise)."""
    if not _is_node(tree):
        return fn(tree, *rest)
    for r in rest:
        if type(r) is not type(tree) or (
                sorted(r) != sorted(tree) if isinstance(tree, dict)
                else len(r) != len(tree)):
            raise ValueError(f"tree structure mismatch: {_shape(tree)} vs "
                             f"{_shape(r)}")
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return [tree_map(fn, c, *(r[i] for r in rest))
            for i, c in enumerate(tree)]


def tree_map_with_path(fn: Callable, tree, prefix: Tuple = ()):
    """``fn(path, leaf)`` over the leaves, keeping the structure."""
    if not _is_node(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return [tree_map_with_path(fn, c, prefix + (i,))
            for i, c in enumerate(tree)]


def unflatten(like, flat: List[Any]):
    """A tree of ``like``'s structure whose leaves are ``flat`` in order."""
    paths = [p for p, _ in leaves_with_path(like)]
    flat = list(flat)
    if len(flat) != len(paths):
        raise ValueError(f"{len(flat)} leaves for a tree of {len(paths)}")
    pos = dict(zip(paths, flat))
    return tree_map_with_path(lambda p, _: pos[p], like)


def unzip2(pairs, like):
    """Split a tree of ``(a, b)`` leaves (structure of ``like``) in two."""
    return (tree_map(lambda _, t: t[0], like, pairs),
            tree_map(lambda _, t: t[1], like, pairs))


def _shape(t):
    if isinstance(t, dict):
        return {k: _shape(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_shape(v) for v in t]
    return "*"
