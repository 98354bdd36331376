"""The kernel boundary for DTensor inputs.

A kernel wrapper handed DTensors runs its kernel on each rank's local
shards (`torch.distributed.tensor.experimental.local_map`) where the
placements allow it, and its outputs come back as DTensors laid out as
the inputs were. What a kernel allows, mesh dim by mesh dim:

- flash attention: batch (dim 0) or heads (dim 2) of q, k and v alike,
  the heads only where both the q heads and the kv heads divide by the
  shards (q head h then still maps to kv head h // (H / K) locally);
- the RG-LRU scan: batch or channel (a, b; h0 alike);
- `pso_update`: any dim of the stacked leaves (elementwise), with the
  coefficients rows following the worker dim and the global leaf the
  rest;
- quantize-pack, its error-feedback form and the decode: the worker dim
  only (a (256, 128) block's scale and the hash's index need the whole
  leaf); an output shaped like the input (a residual, a decode) goes
  back to the input's layout, so that a rank holds one gathered leaf at
  a time;
- `wire_agg`: nothing (it sums over the workers).

Any other placement (a sequence-sharded cache, a partial sum) is
redistributed to `Replicate()` before the launch, and each such call is
counted (`redistributions()`), so a run can show how often the layout
cost a gather. The kernel still launches: nothing here gives way to a
plain version.
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import Callable, Sequence

from repro_torch.sharding.rules import is_dtensor

_REDISTRIBUTED: Counter = Counter()


def redistributions() -> dict[str, int]:
    """Calls of each kernel since the last reset whose inputs had to be
    gathered to Replicate()."""
    return dict(_REDISTRIBUTED)


def reset_redistributions() -> None:
    _REDISTRIBUTED.clear()


def _mesh(args: Sequence):
    return next(a.device_mesh for a in args if is_dtensor(a))


def _placed(x, mesh):
    """A plain tensor as a replicated DTensor (every rank holds it)."""
    if x is None or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def run_local(name: str, fn: Callable, args: Sequence, targets: Sequence,
              out_targets, **kwargs):
    """fn(*local args, **kwargs) on every rank, each DTensor arg first
    laid out as its target placements; returns the outputs as DTensors
    with `out_targets`. A call that turns any sharded or partial
    placement into Replicate() counts once for `name`."""
    mesh = _mesh(args)
    args = [_placed(a, mesh) for a in args]
    for a, t in zip(args, targets):
        if a is not None and t is not None and any(
                not p.is_replicate() and q.is_replicate()
                for p, q in zip(a.placements, t)):
            _REDISTRIBUTED[name] += 1
            break
    from torch.distributed.tensor.experimental import local_map
    return local_map(functools.partial(fn, **kwargs),
                     out_placements=out_targets,
                     in_placements=tuple(None if t is None else tuple(t)
                                         for t in targets),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def relayout(x, placements):
    """The DTensor x redistributed to `placements`, its shard in storage
    of its own (a Replicate-to-Shard slice is a view, which would keep
    the whole tensor alive)."""
    if tuple(x.placements) == tuple(placements):
        return x
    y = x.redistribute(x.device_mesh, placements)
    loc = y.to_local()
    if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
        from torch.distributed.tensor import DTensor
        y = DTensor.from_local(loc.clone(), y.device_mesh, y.placements,
                               run_check=False)
    return y


def _keep(x, allowed) -> list:
    """x's placements with every one not in `allowed(mesh dim, p)`
    replaced by Replicate()."""
    from torch.distributed.tensor import Replicate
    return [p if allowed(m, p) else Replicate()
            for m, p in enumerate(x.placements)]


def _divides(x, dim: int, sizes: Sequence[int], targets) -> bool:
    """Whether dim of x divides by the shards targets put on it."""
    n = 1
    for s, p in zip(sizes, targets):
        if p.is_shard(dim):
            n *= s
    return x.shape[dim] % n == 0


def attention(fn: Callable, q, k, v, **kwargs):
    """flash attention over DTensors (see the module doc)."""
    from torch.distributed.tensor import Replicate
    mesh = _mesh((q, k, v))
    q, k, v = (_placed(t, mesh) for t in (q, k, v))
    sizes = [mesh.size(m) for m in range(mesh.ndim)]
    tgt = _keep(q, lambda m, p: p.is_shard(0) or p.is_shard(2))
    if not (_divides(q, 2, sizes, tgt) and _divides(k, 2, sizes, tgt)):
        tgt = [Replicate() if p.is_shard(2) else p for p in tgt]
    return run_local("flash_attention", fn, (q, k, v), (tgt, tgt, tgt), tgt,
                     **kwargs)


def scan(fn: Callable, h0, a, b):
    """The RG-LRU scan over DTensors: batch or channel shards."""
    from torch.distributed.tensor import Shard
    mesh = _mesh((h0, a, b))
    a = _placed(a, mesh)
    tgt = _keep(a, lambda m, p: p.is_shard(0) or p.is_shard(2))
    tgt0 = [Shard(1) if p.is_shard(2) else p for p in tgt]
    return run_local("rglru_scan", fn, (h0, a, b), (tgt0, tgt, tgt),
                     (tgt, tgt0))


def pso(fn: Callable, coefs, w, v, wl, wg, d):
    """Eq. 8 over DTensors: elementwise on the stacked leaves; the
    coefficient rows go with the worker dim, the global leaf with the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh((coefs, w, v, wl, wg, d))
    w = _placed(w, mesh)
    tgt = _keep(w, lambda m, p: p.is_shard())
    tgt_c = [p if p.is_shard(0) else Replicate() for p in tgt]
    tgt_g = [Shard(p.dim - 1) if p.is_shard() and p.dim > 0 else Replicate()
             for p in tgt]
    return run_local("pso_update", fn, (coefs, w, v, wl, wg, d),
                     (tgt_c, tgt, tgt, tgt, tgt_g, tgt), (tgt, tgt))


def per_worker(name: str, fn: Callable, args: Sequence, n_out: int,
               **kwargs):
    """A wire kernel over DTensors whose args all lead with the worker
    dim: sharded over it or run replicated; outputs shaped like the
    first arg come back in its layout."""
    mesh = _mesh(args)
    first = _placed(args[0], mesh)
    tgt = _keep(first, lambda m, p: p.is_shard(0))
    outs = run_local(name, fn, args, [tgt] * len(args),
                     tuple([tgt] * n_out) if n_out > 1 else tgt, **kwargs)
    back = lambda o: (relayout(o, first.placements)
                      if tuple(o.shape) == tuple(first.shape) else o)
    return tuple(map(back, outs)) if n_out > 1 else back(outs)


def replicated(name: str, fn: Callable, args: Sequence, **kwargs):
    """A kernel that needs every row (wire_agg): run on every rank over
    the replicated inputs."""
    from torch.distributed.tensor import Replicate
    mesh = _mesh(args)
    rep = [Replicate()] * mesh.ndim
    return run_local(name, fn, args, [None if a is None else rep
                                      for a in args], rep, **kwargs)
