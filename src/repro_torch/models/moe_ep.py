"""Expert-parallel MoE dispatch over a mesh axis's process group (the JAX
package's `models/moe_ep.py`, where a `shard_map` runs the body).

The sort-based dispatch of `moe.moe_apply` needs every token beside every
expert. The expert-parallel pattern exchanges only capacity-bounded
buffers, each shard holding E / n experts and B / n of the batch:

  1. per token shard: route, pack the (token, k) picks by destination
     expert shard into (n, cap_send, D) (`route`, `pack_send`),
  2. all-to-all over the expert axis (picks, their expert ids and a
     valid flag: three exchanges),
  3. pack by local expert id into (E_local, cap_local, D), run the
     expert FFN, un-pack (`expert_ffn`),
  4. all-to-all back, combine with the router gates at the origin
     (`combine`).

Per-shard traffic: O(T K cf D / n) instead of O(T K D). Everything is
shape-static (GShard capacity semantics: picks past a capacity drop, at
the send and at the local stage, so EP drops at two capacities by
design; dropless at cf >= E / K). The load-balance aux sums its two
statistics over the axis (`all_reduce`).

The exchanges are `torch.distributed.nn.functional.all_to_all_single`
(differentiable: the reference trains through EP) over the axis's group.
The stages are module-level functions of local tensors, so one process
can also drive n shards, exchanging as a tiled all-to-all does
(`buf.view(n, n, cap, D).transpose(0, 1)`): the tests and the card's
check do that; the package has no such mode.

The region is manual over the expert axis only in the reference, the
model axis staying with the partitioner (the FFN's f dim stays
tensor-parallel). Here every other mesh axis is replicated at the
region's entry, as the reference's own fallback for old jax does: the
expert FFN loses tensor parallelism inside the region, the arithmetic
is the same.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import axis_names, axis_size, is_dtensor

PyTree = Any
F32 = torch.float32


def _pack(ids: torch.Tensor, n_bins: int, cap: int, payload: dict,
          valid: Optional[torch.Tensor] = None
          ) -> tuple[dict, torch.Tensor]:
    """Pack M items into (n_bins, cap, ...) capacity buffers.

    ids: (M,) int bin per item; payload: dict of (M, ...) tensors.
    Returns (buffers, slot) where slot[m] = flat index bin * cap + pos of
    item m, or the sentinel n_bins * cap if dropped (overflow / ~valid).
    One stable argsort serves every payload leaf (within a bin, items
    keep their order, which decides the drops, as `jnp.argsort`); the
    counts are a `scatter_add_` (`bincount` reads back to the host)."""
    M = ids.shape[0]
    if valid is not None:
        ids = torch.where(valid, ids, n_bins)            # sentinel bin
    sort_idx = torch.argsort(ids, stable=True)
    sorted_ids = ids[sort_idx]
    counts = ids.new_zeros(n_bins + 1).scatter_add_(0, ids,
                                                    torch.ones_like(ids))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(M, device=ids.device) - starts[sorted_ids]
    keep = (pos < cap) & (sorted_ids < n_bins)
    dest_slot = torch.where(keep, sorted_ids * cap + pos, n_bins * cap)

    def pack_leaf(x):
        buf = x.new_zeros((n_bins * cap + 1,) + tuple(x.shape[1:]))
        # the sentinel row takes every dropped item and is cut off
        buf = buf.index_copy(0, dest_slot, x[sort_idx])
        return buf[:n_bins * cap].reshape((n_bins, cap) + tuple(x.shape[1:]))

    bufs = {k: pack_leaf(v) for k, v in payload.items()}
    # slot per ORIGINAL item: invert the sort
    inv = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(M, device=ids.device))
    return bufs, dest_slot[inv]


# ---------------------------------------------------------------------------
# the stages (local tensors; one expert shard each)
# ---------------------------------------------------------------------------

def capacities(tokens: int, cfg, n: int) -> tuple[int, int]:
    """(cap_send, cap_local) for `tokens` global tokens over n shards, as
    the reference: a shard sends ceil(Tl K / n cf) picks to each shard,
    and an expert takes ceil(T K / E cf)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    cf = cfg.moe_capacity_factor
    Tl = tokens // n
    return (max(int(math.ceil(Tl * K / n * cf)), 1),
            max(int(math.ceil(tokens * K / E * cf)), 1))


def route(hf: torch.Tensor, router: torch.Tensor, K: int):
    """(Tl, D) -> probs (Tl, E) f32, gates (Tl, K) renormalised, expert
    ids (Tl, K)."""
    probs = torch.softmax(hf.to(F32) @ router, dim=-1)
    gates, idx = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx


def aux_stats(probs: torch.Tensor, idx: torch.Tensor, E: int
              ) -> torch.Tensor:
    """This shard's (2, E) f32 load statistics: its picks per expert and
    its summed router probabilities (the aux's two sums over shards)."""
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=F32, device=idx.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=F32, device=idx.device))
    return torch.stack([counts, probs.sum(dim=0)])


def aux_loss(stats: torch.Tensor, tokens: int, cfg) -> torch.Tensor:
    """The Shazeer aux from the (2, E) statistics summed over shards:
    E * sum_e(dispatch fraction_e * mean gate_e)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    return E * torch.sum(stats[0] / (tokens * K) * (stats[1] / tokens))


def pack_send(hf: torch.Tensor, idx: torch.Tensor, E_local: int, n: int,
              cap_send: int) -> tuple[dict, torch.Tensor]:
    """The picks packed by destination shard: {"x": (n, cap, D), "e":
    (n, cap) global expert ids, "v": (n, cap) 1 where a pick sits (an
    empty slot carries e = 0)}, and each pick's send slot."""
    Tl, K = idx.shape
    flat_e = idx.reshape(Tl * K)
    tok = torch.arange(Tl * K, device=idx.device) // K
    return _pack(flat_e // E_local, n, cap_send,
                 {"x": hf[tok], "e": flat_e,
                  "v": torch.ones_like(flat_e, dtype=torch.int8)})


def expert_ffn(rx: torch.Tensor, re: torch.Tensor, rv: torch.Tensor,
               shard: int, E_local: int, cap_local: int, wi: torch.Tensor,
               wu: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The received picks (n * cap_send, D) -> their rows through this
    shard's experts (zero for an empty or dropped slot), in the same
    slots, ready for the return exchange."""
    D = rx.shape[-1]
    local_e = re - shard * E_local
    xs, slot = _pack(local_e, E_local, cap_local, {"x": rx},
                     valid=(rv > 0) & (local_e >= 0) & (local_e < E_local))
    xs = xs["x"]                                          # (El, cap, D)
    a = F.silu(torch.bmm(xs, wi))
    ys = torch.bmm(a * torch.bmm(xs, wu), wo)
    ys_flat = torch.cat([ys.reshape(E_local * cap_local, D),
                         ys.new_zeros((1, D))])
    return ys_flat[slot]


def combine(origin: torch.Tensor, slot_send: torch.Tensor,
            gates: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The returned rows (n * cap_send, D) -> (Tl, D): each pick's row
    weighted by its gate in f32, summed over k."""
    Tl, K = gates.shape
    D = origin.shape[-1]
    origin = torch.cat([origin, origin.new_zeros((1, D))])
    contrib = origin[slot_send].view(Tl, K, D)
    return torch.einsum("tkd,tk->td", contrib.to(F32), gates).to(dtype)


def ep_body(hl: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
            wu: torch.Tensor, wo: torch.Tensor, cfg, n: int, shard: int,
            tokens: int, exchange: Callable, psum: Callable
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's EP MoE: hl (B/n, S, D) pre-normed, its E / n experts'
    weights; `exchange(t)` is the tiled all-to-all of an (n, cap, ...)
    buffer over the axis, `psum` the sum over it. Returns (y local,
    aux)."""
    D = hl.shape[-1]
    E, K = cfg.num_experts, cfg.experts_per_token
    E_local = E // n
    cap_send, cap_local = capacities(tokens, cfg, n)
    hf = hl.reshape(-1, D)
    probs, gates, idx = route(hf, router, K)
    aux = aux_loss(psum(aux_stats(probs, idx, E)), tokens, cfg)
    send, slot_send = pack_send(hf, idx, E_local, n, cap_send)
    rx = exchange(send["x"]).reshape(n * cap_send, D)
    re = exchange(send["e"]).reshape(n * cap_send)
    rv = exchange(send["v"]).reshape(n * cap_send)
    back = expert_ffn(rx, re, rv, shard, E_local, cap_local, wi, wu, wo)
    origin = exchange(back.view(n, cap_send, D)).reshape(n * cap_send, D)
    return combine(origin, slot_send, gates, hl.dtype).view(hl.shape), aux


# ---------------------------------------------------------------------------
# over a process group
# ---------------------------------------------------------------------------

class _PSum(torch.autograd.Function):
    """all_reduce(SUM) whose result every shard uses alike (the aux): the
    cotangent of each shard's input is the output's, unsummed."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _a2a(group) -> Callable:
    """The tiled all-to-all of an (n, cap, ...) buffer over `group`:
    differentiable for float buffers, plain for the id buffers."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dnn

    def exchange(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if t.is_floating_point():
            return dnn.all_to_all_single(torch.empty_like(t), t, group=group)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out
    return exchange


def moe_apply_ep(params: PyTree, h, cfg, mesh, axis_name: str):
    """Expert-parallel MoE over `axis_name` of `mesh`. h: (B, S, D)
    pre-normed DTensor; the expert weights DTensors (or plain tensors:
    the whole replicated weights). Needs E % n == 0 and B % n == 0.
    Returns (y, aux) as DTensors: y batch-sharded over the axis, aux
    replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = axis_names(mesh)
    dim = names.index(axis_name)
    n = axis_size(mesh, axis_name)
    shard = mesh.get_local_rank(axis_name)
    rep = [Replicate()] * len(names)
    split = list(rep)
    split[dim] = Shard(0)
    B, S, _ = h.shape
    E_local = cfg.num_experts // n

    def local(x, pl, grad_pl=None):
        if not is_dtensor(x):
            return x
        return x.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    def local_experts(w):
        if is_dtensor(w):
            return local(w, split)
        return w[shard * E_local:(shard + 1) * E_local]

    if not is_dtensor(h):
        h = DTensor.from_local(h, mesh, rep)
    hl = local(h, split)
    # each shard's router gradient is its own tokens' share of the sum
    router_grad = list(rep)
    router_grad[dim] = Partial()
    router = local(params["router"], rep, router_grad)
    group = mesh.get_group(axis_name)
    y, aux = ep_body(hl, router, local_experts(params["wi"]),
                     local_experts(params["wu"]),
                     local_experts(params["wo"]), cfg, n, shard, B * S,
                     _a2a(group), lambda t: _PSum.apply(t, group))
    return (DTensor.from_local(y, mesh, split),
            DTensor.from_local(aux, mesh, rep))


def ep_applicable(cfg, mesh, rules) -> Optional[str]:
    """The EP axis name if the all-to-all dispatch applies."""
    if mesh is None or rules is None:
        return None
    if not rules.get("moe_ep", False):
        return None
    axis = rules.get("expert")
    if not isinstance(axis, str) or axis not in axis_names(mesh):
        return None
    n = axis_size(mesh, axis)
    if n <= 1 or cfg.num_experts % n:
        return None
    return axis
