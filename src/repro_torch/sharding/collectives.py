"""Collectives over a mesh's dims for the regions that the port lays out
by hand on local shards, as the reference's partitioner lays them out:
the vocab-parallel embedding lookup (`models/layers.embed`) and the
expert-sharded dense MoE dispatch (`models/moe.py`).

Each is a functional collective (`torch.distributed._functional_collectives`)
over one mesh dim's group, waited at once, so that it runs under fake
tensors, in `checkpoint`'s recompute and on autograd's device thread, and
the cost model (`launch/op_costmodel`) counts it by kind. A mesh dim of
one rank moves nothing and issues nothing (`placements` replicates such
dims, so no region is cut over one).

Two autograd Functions carry the regions' gradients without DTensor's
redistribution rules (whose handling of a `Partial` input's gradient
changed between torch releases):

- `gather_sum`: a rank's (n_local, ...) block, partial over some dims and
  cut along dim 0 over others, summed and gathered whole on every rank;
  its consumer is replicated, so the backward is the rank's slice of the
  gradient, with no communication;
- `sum_grad`: the identity on a tensor every rank holds alike, whose
  consumers each see a part: the backward sums the gradient over the
  dims (one all-reduce).
"""
from __future__ import annotations

from typing import Sequence

import torch


def shard_dims(placements: Sequence, dim: int) -> tuple[int, ...]:
    """The mesh dims whose placement shards tensor dim `dim`."""
    return tuple(m for m, p in enumerate(placements) if p.is_shard(dim))


def offset(size: int, mesh, dims: Sequence[int]) -> tuple[int, int]:
    """(start, length) of this rank's chunk of a tensor dim of `size`
    cut over mesh dims `dims` (in mesh order, major first, as DTensor
    cuts a dim that several mesh dims shard; the sizes divide)."""
    lo, n = 0, size
    for m in sorted(dims):
        n //= mesh.size(m)
        lo += mesh.get_local_rank(m) * n
    return lo, n


def all_reduce(t: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """t summed over the groups of mesh dims `dims`."""
    import torch.distributed._functional_collectives as funcol
    for m in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, "sum", (mesh, m)))
    return t


def all_gather(t: torch.Tensor, mesh, dims: Sequence[int], dim: int = 0
               ) -> torch.Tensor:
    """The chunks of t along `dim` over mesh dims `dims` (cut in mesh
    order, major first), gathered whole: the minor dim first, so that a
    major rank's block holds its minor ranks' chunks in order."""
    import torch.distributed._functional_collectives as funcol
    # torch 2.13 renamed all_gather_tensor (the card's torch 2.11 has only
    # that name) and warns at the old one
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    for m in sorted(dims, reverse=True):
        t = funcol.wait_tensor(gather(t, dim, (mesh, m)))
    return t


class _GatherSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, cut: tuple, partial: tuple, dtype):
        ctx.lo, ctx.n = offset(x.shape[0] * _size(mesh, cut), mesh, cut)
        ctx.dtype = x.dtype
        return all_gather(all_reduce(x, mesh, partial).to(dtype), mesh, cut)

    @staticmethod
    def backward(ctx, g):
        return (g[ctx.lo:ctx.lo + ctx.n].to(ctx.dtype), None, None, None,
                None)


class _SumGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, dims: tuple):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.dims), None, None


def _size(mesh, dims: Sequence[int]) -> int:
    n = 1
    for m in dims:
        n *= mesh.size(m)
    return n


def gather_sum(x: torch.Tensor, mesh, cut: Sequence[int],
               partial: Sequence[int], dtype=None) -> torch.Tensor:
    """x, this rank's block of a tensor cut along dim 0 over mesh dims
    `cut` and a partial sum over mesh dims `partial`: the whole tensor,
    summed (in x's dtype), cast to `dtype` (None: x's) and gathered, on
    every rank. The consumer must be the same on every rank (its
    gradient replicated)."""
    dtype = x.dtype if dtype is None else dtype
    if not cut and not partial:
        return x.to(dtype)
    return _GatherSum.apply(x, mesh, tuple(cut), tuple(partial), dtype)


def sum_grad(x: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """x unchanged; its gradient summed over mesh dims `dims`."""
    if not dims or not x.requires_grad:
        return x
    return _SumGrad.apply(x, mesh, tuple(dims))
