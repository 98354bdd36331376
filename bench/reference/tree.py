"""Nested dicts of tensors as leaf lists, keys in sorted order (the
order the wire's per-leaf seeds follow)."""
from __future__ import annotations


def paths(tree: dict, prefix: str = "") -> list[str]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else k
        out += paths(v, p) if isinstance(v, dict) else [p]
    return out


def leaves(tree: dict) -> list:
    return [get(tree, p) for p in paths(tree)]


def get(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def like(tree: dict, values: list) -> dict:
    """A tree shaped as `tree` holding `values` in sorted-path order."""
    it = iter(values)

    def walk(node):
        return {k: walk(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}
    return walk(tree)


def tmap(fn, *trees) -> dict:
    return like(trees[0], [fn(*xs) for xs in zip(*(leaves(t) for t in trees))])
