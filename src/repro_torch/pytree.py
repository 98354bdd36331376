"""Minimal pytree helpers over the nested param dicts the models use.

Dict keys flatten in sorted order, as `jax.tree` does, so leaf i here is
leaf i of the JAX package's params — the per-leaf wire seeds and payloads
line up leaf for leaf. Tuples (NamedTuples included) and lists recurse;
None is an empty node; anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def _children(node):
    if isinstance(node, dict):
        keys = sorted(node)
        return [node[k] for k in keys], ("dict", keys)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node), ("namedtuple", type(node))
    if isinstance(node, (list, tuple)):
        return list(node), (type(node).__name__, None)
    if node is None:
        return [], ("none", None)
    return None, None


def tree_flatten(tree: PyTree) -> tuple[list, Any]:
    """(leaves, treedef) with leaves in JAX order."""
    kids, meta = _children(tree)
    if kids is None:
        return [tree], ("leaf", None)
    leaves, defs = [], []
    for k in kids:
        lv, d = tree_flatten(k)
        leaves.extend(lv)
        defs.append((len(lv), d))
    return leaves, (meta, defs)


def tree_unflatten(treedef, leaves) -> PyTree:
    leaves = list(leaves)
    if treedef[0] == "leaf":
        return leaves[0]
    (kind, info), defs = treedef
    out, i = [], 0
    for n, d in defs:
        out.append(tree_unflatten(d, leaves[i:i + n]))
        i += n
    if kind == "dict":
        return dict(zip(info, out))
    if kind == "namedtuple":
        return info(*out)
    if kind == "none":
        return None
    return tuple(out) if kind == "tuple" else out


def tree_leaves_with_path(tree: PyTree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in tree_flatten's order; a path is the tuple of the
    leaf's keys as strings: a dict's key, a NamedTuple's field name, a
    list or tuple index (jax.tree_util's DictKey, GetAttrKey and
    SequenceKey)."""
    kids, meta = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    kind, info = meta
    names = (info if kind == "dict" else info._fields
             if kind == "namedtuple" else range(len(kids)))
    return [pl for n, k in zip(names, kids)
            for pl in tree_leaves_with_path(k, prefix + (str(n),))]


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
