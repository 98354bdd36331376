"""Pytree checkpoints to .npz, in the JAX package's archive format.

Leaves are flattened to path-keyed arrays: the path elements of a leaf
(a dict's key, a list or tuple index, a NamedTuple's field name) joined
by "/", in `repro_torch.pytree`'s order, which is jax.tree's. A
`__meta__` entry holds the sorted keys and the caller's metadata as
JSON. Files are written to a temporary file and renamed into place, and
`CheckpointManager` names them `ckpt_<step:08d>.npz`. So a file either
package writes restores in the other.

bfloat16: numpy has none, so a bf16 leaf is saved as its 2-byte words
in a `|V2` array, byte for byte what `np.savez` writes for a JAX bf16
leaf. `restore_pytree(like=...)` reads `|V2` words back as bf16 bits and
casts each leaf to its template leaf's dtype on the template's device;
without a template it returns the nested dict of numpy arrays the JAX
package returns (bf16 leaves as `|V2`).
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.bridge import array_to_tensor, tensor_to_array
from repro_torch.pytree import (tree_flatten, tree_leaves_with_path,
                                tree_unflatten)

PyTree = Any

_SEP = "/"


def _paths(tree: PyTree) -> list[tuple[str, Any]]:
    """(key, leaf) in tree_flatten's order, keys as the JAX package's
    `_path_elem` builds them."""
    return [(_SEP.join(p), leaf) for p, leaf in tree_leaves_with_path(tree)]


def _to_array(leaf) -> np.ndarray:
    return (tensor_to_array(leaf) if torch.is_tensor(leaf)
            else np.asarray(leaf))


def save_pytree(path: str | os.PathLike, tree: PyTree,
                metadata: Optional[dict] = None) -> None:
    """Atomic save (write a temporary file, then rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: _to_array(v) for k, v in _paths(tree)}
    meta = {"keys": sorted(flat), "metadata": metadata or {}}
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **flat)
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def _cast_like(arr: np.ndarray, leaf):
    """A saved array placed as the template leaf: a tensor of its dtype
    on its device, or (for a non-tensor leaf) the array itself."""
    if not torch.is_tensor(leaf):
        return arr
    return array_to_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)


def restore_pytree(path: str | os.PathLike,
                   like: Optional[PyTree] = None) -> PyTree:
    """Restore. With `like`, leaves are placed into the template's
    structure (each cast to its template leaf's dtype and device);
    without it, returns a nested dict of numpy arrays following the
    saved paths."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    if like is not None:
        keys = [k for k, _ in _paths(like)]
        missing = set(keys) - set(flat)
        extra = set(flat) - set(keys)
        if missing or extra:
            raise ValueError(
                f"checkpoint/template mismatch: missing={sorted(missing)[:5]} "
                f"extra={sorted(extra)[:5]}")
        leaves, treedef = tree_flatten(like)
        return tree_unflatten(treedef, [_cast_like(flat[k], leaf)
                                        for k, leaf in zip(keys, leaves)])
    out: dict = {}
    for key, arr in flat.items():
        node = out
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def read_metadata(path: str | os.PathLike) -> dict:
    with np.load(path) as data:
        if "__meta__" not in data.files:
            return {}
        raw = bytes(data["__meta__"].tobytes())
    return json.loads(raw).get("metadata", {})


class CheckpointManager:
    """Step-indexed checkpoints with retention, ckpt_<step>.npz."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3):
        self.dir = Path(directory)
        self.max_to_keep = max_to_keep
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.npz"

    def all_steps(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1])
                      for p in self.dir.glob("ckpt_*.npz"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: PyTree,
             metadata: Optional[dict] = None) -> Path:
        p = self._path(step)
        save_pytree(p, tree, metadata={"step": step, **(metadata or {})})
        for s in self.all_steps()[: -self.max_to_keep]:
            self._path(s).unlink(missing_ok=True)
        return p

    def restore(self, step: Optional[int] = None,
                like: Optional[PyTree] = None) -> tuple[int, PyTree]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step, restore_pytree(self._path(step), like=like)
