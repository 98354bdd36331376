"""Per-leaf specs for parameter and cache pytrees, by tree path (the JAX
package's `sharding/param_specs.py`).

`spec_for_path(path, shape, rules, mesh)` matches the leaf's path suffix
against a table of logical-axis layouts (right-aligned to the leaf rank:
leading stack dims like the layer-group axis are unsharded), resolves
logical names through the `ShardingRules`, and *drops any mesh axis
that does not divide the dim* (e.g. SmolLM's 15 heads on a 16-way model
axis fall back to replicated; the MLP dim still shards). That keeps
every (arch x mesh) combination placeable without per-arch cases.

Paths are the reference's strings: dict keys, NamedTuple field names and
sequence indices joined by "/" (`a/b/0`). `tree_shardings` gives each
tensor leaf a `Layout`: its spec and its DTensor placements on the mesh.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch

from repro_torch.pytree import tree_flatten, tree_leaves_with_path, \
    tree_unflatten
from repro_torch.sharding.rules import (ShardingRules, axes_size,
                                        axis_names, norm_entry, placements)

PyTree = Any

# (path regex, logical names right-aligned to the leaf's trailing dims)
_PARAM_TABLE: list[tuple[str, tuple[Optional[str], ...]]] = [
    (r"embed/table$", ("vocab", "embed_fsdp")),
    (r"temporal/wq$", ("embed_fsdp", "heads", None)),
    (r"(temporal|cross)/w[kv]$", ("embed_fsdp", "kv_heads", None)),
    (r"cross/wq$", ("embed_fsdp", "heads", None)),
    (r"(temporal|cross)/wo$", ("heads", None, "embed_fsdp")),
    (r"moe/router$", ("embed_fsdp", None)),
    (r"moe/w[iu]$", ("expert", "embed_fsdp", "expert_mlp")),
    (r"moe/wo$", ("expert", "expert_mlp", "embed_fsdp")),
    (r"dense/w[iu]$", ("embed_fsdp", "mlp")),
    (r"dense/wo$", ("mlp", "embed_fsdp")),
    (r"mlp/w[iu]$", ("embed_fsdp", "mlp")),
    (r"mlp/wo$", ("mlp", "embed_fsdp")),
    # rglru
    (r"temporal/w[xyo]$", ("embed_fsdp", "mlp")),
    (r"temporal/w_[ri]$", ("embed_fsdp", "mlp")),
    (r"temporal/conv$", (None, "mlp")),
    (r"temporal/(b_[ri]|lam)$", ("mlp",)),
    # mlstm / slstm
    (r"temporal/w_(up|gate|in)$", ("embed_fsdp", "mlp")),
    (r"temporal/m[qkv]$", ("embed_fsdp", "mlp")),  # (di, di) in mlstm
    (r"temporal/w_down$", ("mlp", "embed_fsdp")),
    (r"temporal/w_if$", ("embed_fsdp", None)),
    (r"temporal/w_rec$", (None, None, None)),
    (r"temporal/b(_if)?$", (None,)),
    # plain-mlp mixers in attention blocks (non-moe)
    (r"w[iu]$", ("embed_fsdp", "mlp")),
    (r"wo$", ("mlp", "embed_fsdp")),
    (r"(norm|out_norm|final_norm)/scale$", (None,)),
]

_CACHE_TABLE: list[tuple[str, tuple[Optional[str], ...]]] = [
    (r"temporal/[kv]$", ("cache_batch", "cache_seq", "act_kv_heads", None)),
    (r"temporal/pos$", ()),
    (r"cross_kv.*$", (None, "cache_batch", "cache_seq", "act_kv_heads",
                      None)),
    (r"temporal/h$", ("cache_batch", "mlp")),
    (r"temporal/conv$", ("cache_batch", None, "mlp")),
    (r"temporal/C$", ("cache_batch", None, None, None)),
    (r"temporal/[nm]$", ("cache_batch", None, None)),
    (r"temporal/c$", ("cache_batch", "mlp")),
]


@dataclasses.dataclass(frozen=True)
class Layout:
    """A leaf's spec and its DTensor placements on the mesh (a leaf of
    the pytree helpers, where a NamedTuple would be a node)."""
    spec: tuple
    placements: tuple


def _resolve(names: tuple[Optional[str], ...], shape: tuple[int, ...],
             rules: ShardingRules, mesh) -> tuple:
    """Right-align names to shape; drop axes that don't divide or that an
    earlier dim already uses (e.g. MoE's expert dim takes "data" in FSDP
    mode, so embed_fsdp falls back to replicated for expert weights)."""
    ndim = len(shape)
    full = (None,) * (ndim - len(names)) + names
    return _dedup_and_divide(full, shape, rules, mesh)


def _dedup_and_divide(full, shape, rules, mesh) -> tuple:
    out = []
    used: set[str] = set()
    for dim, name in zip(shape, full):
        # `name` is a logical axis (resolve through rules), an already-
        # resolved mesh axis (use as-is; the worker prefix arrives
        # pre-resolved), or a tuple of mesh axes
        if isinstance(name, str):
            if name in rules:
                axes = rules[name]
            elif name in axis_names(mesh):
                axes = name
            else:
                axes = None
        else:
            axes = name
        if axes is None:
            out.append(None)
            continue
        ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        if any(a in used for a in ax_tuple):
            out.append(None)
            continue
        if dim % axes_size(mesh, ax_tuple) == 0:
            out.append(norm_entry(axes))
            used.update(ax_tuple)
        else:
            out.append(None)
    return tuple(out)


def spec_for_path(path: str, shape: tuple[int, ...], rules: ShardingRules,
                  mesh, table: str = "param") -> tuple:
    tbl = _PARAM_TABLE if table == "param" else _CACHE_TABLE
    for pattern, names in tbl:
        if re.search(pattern, path):
            names = names[:len(shape)] if len(names) > len(shape) else names
            return _resolve(names, tuple(shape), rules, mesh)
    return ()  # replicate by default


def _path_str(path) -> str:
    """A leaf path (the keys `pytree.tree_leaves_with_path` gives) as the
    reference's "a/b/0" string."""
    return "/".join(str(p) for p in path)


def _leaf_spec(path, x, rules: ShardingRules, mesh, table: str = "param",
              prefix_axes: int = 0, prefix_spec: Optional[tuple] = None
              ) -> tuple:
    """The spec of one leaf; `prefix_axes` dims at the front get
    `prefix_spec` (the worker dim)."""
    shape = tuple(x.shape)
    spec = spec_for_path(_path_str(path), shape[prefix_axes:], rules, mesh,
                         table)
    if prefix_axes:
        pre = prefix_spec if prefix_spec is not None else (None,) * prefix_axes
        body = tuple(spec) + (None,) * (len(shape) - prefix_axes - len(spec))
        spec = _dedup_and_divide(tuple(pre) + body, shape, rules, mesh)
    return spec


def tree_shardings(tree: PyTree, rules: ShardingRules, mesh,
                   table: str = "param", prefix_axes: int = 0,
                   prefix_spec: Optional[tuple] = None) -> PyTree:
    """A `Layout` per leaf of `tree` (meta or real tensors; a leaf that
    is no tensor, a cache's int `pos`, is a scalar: replicated)."""
    leaves, treedef = tree_flatten(tree)
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    out = []
    for path, x in zip(paths, leaves):
        spec = (_leaf_spec(path, x, rules, mesh, table, prefix_axes,
                          prefix_spec) if torch.is_tensor(x) else ())
        out.append(Layout(spec, placements(spec, mesh)))
    return tree_unflatten(treedef, out)
