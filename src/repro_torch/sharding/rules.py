"""Logical-axis sharding rules of the port (the JAX package's
`sharding/rules.py`), on torch DeviceMesh and DTensor.

Model code names tensor dims with *logical* axes ("batch", "embed",
"heads", "expert", ...). A `ShardingRules` table maps each logical axis
to mesh axes (or None: replicated). The deployment modes (the pure-TP
swarm, the FSDP+TP time-multiplexed swarm, multi-pod) swap the table
without touching model code.

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a
tuple of them, or None, element for element the reference's
`PartitionSpec`. `placements(spec, mesh)` turns it into DTensor
placements: `Shard(dim)` on each mesh dim that tensor dim `dim` names,
`Replicate()` on the others (a tuple of mesh axes on one dim shards it
over them in mesh order, major first, as the reference's does).

`shard(x, names)` is the port's `with_sharding_constraint`: with rules
and a mesh active and `x` a DTensor, it redistributes `x` to the
resolved placements on `x`'s own mesh (axes that mesh lacks, and axes
that do not divide the dim, are left replicated); otherwise it returns
`x` unchanged, so a run without a mesh (every CPU test, every
one-process entry point) takes none of this.
"""
from __future__ import annotations

import contextlib
import sys
import types
from typing import Any, Optional, Sequence, Union

MeshAxes = Union[None, str, tuple[str, ...]]
Spec = tuple


def norm_entry(entry: MeshAxes) -> MeshAxes:
    """A spec entry as `PartitionSpec` keeps it: a one-axis tuple is the
    axis name, an empty one None."""
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


class ShardingRules(dict):
    """logical axis name -> mesh axis (str), tuple of axes, or None."""

    def spec(self, names: Sequence[Optional[str]]) -> Spec:
        """Resolve logical names; a mesh axis already used by an earlier
        dim is dropped from later dims (e.g. MoE's expert dim takes
        "data" in FSDP mode, so embed_fsdp inside expert weights
        replicates)."""
        out = []
        used: set[str] = set()
        for n in names:
            axes = self.get(n) if n is not None else None
            if axes is None:
                out.append(None)
                continue
            ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
            if any(a in used for a in ax_tuple):
                out.append(None)
            else:
                out.append(norm_entry(axes))
                used.update(ax_tuple)
        return tuple(out)


# --- canonical rule tables -------------------------------------------------
# worker: the swarm dim (spatial workers). batch: per-worker batch.
# embed_fsdp: the FSDP dim of weights (row dim) when FSDP is on.

UNSHARDED = ShardingRules()

SINGLE_POD_TP = ShardingRules(
    worker="data", batch=None, seq=None,
    embed=None, embed_fsdp=None,
    heads="model", kv_heads="model", q_per_kv=None, head_dim=None,
    act_heads="model", act_kv_heads="model", residual_seq="model",
    mlp="model", vocab="model",
    expert="model", expert_mlp=None,
    cache_batch=None, cache_seq=None,
)

SINGLE_POD_FSDP_TP = ShardingRules(
    worker=None, batch="data", seq=None,
    embed=None, embed_fsdp="data",
    heads="model", kv_heads="model", q_per_kv=None, head_dim=None,
    act_heads="model", act_kv_heads="model", residual_seq="model",
    moe_ep=True,
    mlp="model", vocab="model",
    expert="data", expert_mlp="model",
    cache_batch="data", cache_seq=None,
)

MULTI_POD_TP = ShardingRules(
    worker=("pod", "data"), batch=None, seq=None,
    embed=None, embed_fsdp=None,
    heads="model", kv_heads="model", q_per_kv=None, head_dim=None,
    act_heads="model", act_kv_heads="model", residual_seq="model",
    mlp="model", vocab="model",
    expert="model", expert_mlp=None,
    cache_batch=None, cache_seq=None,
)

MULTI_POD_FSDP_TP = ShardingRules(
    worker="pod", batch="data", seq=None,
    embed=None, embed_fsdp="data",
    heads="model", kv_heads="model", q_per_kv=None, head_dim=None,
    act_heads="model", act_kv_heads="model", residual_seq="model",
    mlp="model", vocab="model",
    expert="data", expert_mlp="model",
    cache_batch="data", cache_seq=None,
)

# serving rules are derived by the launcher (batch over data, cache over
# data; long-context: cache_seq over data): launch/steps.serve_rules.

# process-wide, not thread-local as the reference's: on a card autograd
# runs the backward (and `checkpoint`'s recompute of a layer group) on its
# own device thread, which must see the rules the forward ran under
_state = types.SimpleNamespace(rules=None, mesh=None)


def set_rules(rules: Optional[ShardingRules], mesh: Any) -> None:
    _state.rules = rules
    _state.mesh = mesh


def get_rules() -> tuple[Optional[ShardingRules], Any]:
    return _state.rules, _state.mesh


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules], mesh: Any):
    prev = get_rules()
    set_rules(rules, mesh)
    try:
        yield
    finally:
        set_rules(*prev)


def logical_to_spec(names: Sequence[Optional[str]]) -> Optional[Spec]:
    rules, _ = get_rules()
    if rules is None:
        return None
    return rules.spec(names)


# ---------------------------------------------------------------------------
# meshes and placements
# ---------------------------------------------------------------------------

def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names: a DeviceMesh's `mesh_dim_names`, or
    `axis_names` / the keys of a `shape` dict (the stand-in meshes the
    spec tests use)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        names = tuple(mesh.shape)
    return tuple(names)


def axis_size(mesh, name: str) -> int:
    shape = mesh.shape
    if isinstance(shape, dict):
        return int(shape[name])
    return int(shape[axis_names(mesh).index(name)])


def axes_size(mesh, axes: MeshAxes) -> int:
    """Product of the sizes of `axes` (a name, a tuple or None) on mesh."""
    if axes is None:
        return 1
    size = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        size *= axis_size(mesh, a)
    return size


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: Shard(dim) on each mesh
    dim that tensor dim `dim` names, Replicate() on the rest. Axes the
    mesh lacks are ignored, and so are axes of size 1 (a shard over one
    rank is the whole tensor, and DTensor's view rules refuse to reshape
    a dim sharded so when its size is 1)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            if a in names and axis_size(mesh, a) > 1:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def fit(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """`spec` on `mesh` for a tensor of `shape`: each entry cut to the
    axes the mesh has, and dropped where their sizes do not divide the
    dim."""
    names = axis_names(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            out.append(None)
            continue
        axes = tuple(a for a in ((entry,) if isinstance(entry, str)
                                 else entry) if a in names)
        if not axes or dim % axes_size(mesh, axes):
            out.append(None)
        else:
            out.append(axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor, without importing the DTensor package
    (none can exist before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def shard(x, names: Sequence[Optional[str]]):
    """Constrain a DTensor to the layout the active rules give `names`;
    a no-op with no rules or mesh active, or on a plain tensor."""
    rules, mesh = get_rules()
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    m = x.device_mesh
    pl = placements(fit(rules.spec(names), x.shape, m), m)
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(m, pl)
