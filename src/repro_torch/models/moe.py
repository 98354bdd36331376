"""Mixture-of-Experts channel mixer of the port (top-k routing,
sort-based dispatch), as the JAX package's `models/moe.py`.

The router runs in f32 (softmax, top K, gates renormalised by their
sum); the (token, k) picks are sorted by expert with a stable sort, the
first `cap` of each expert are packed into an (E * cap + 1, D) buffer
whose last row is the drop slot, the experts' gated FFN runs as batched
products over (E, cap, D), and each pick's row is gathered back through
the inverse of the sort, weighted by its gate in f32 and summed over k.
Picks past an expert's capacity are dropped (GShard semantics), decode
included: at batch 4 one decode step has T = 4 tokens and Qwen3's
capacity is 1, so two tokens that pick the same expert lose one row,
as in the reference.

The capacity is fixed on the host from the shapes; nothing is read back
from the device. The reference's dispatch has no Pallas kernel (it is
sort, scatter and einsum, left to XLA), so this module launches none:
`torch.argsort`, `index_copy_`, `bmm` and indexing.

On a mesh (`sharding.use_rules` active, x a DTensor): when the rules ask
for it (`moe_ep`, `moe_ep.ep_applicable`) and the batch divides the
expert axis, the expert-parallel all-to-all dispatch of `moe_ep` runs
(Arctic's dense residual beside it); otherwise the sort-based dispatch
runs on every rank on local copies of the replicated tokens and of every
expert's weights (the layout the reference pins its scatter and gather
to; the reference's expert-sharded products are not followed there, so
a mesh that shards the experts should take the EP dispatch) and the
output is constrained like the reference's.

Returns (y, aux): aux is the load-balance loss of Shazeer et al.,
E * sum_e(dispatch fraction_e * mean gate_e), which the trainer adds to
the task loss.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import moe_ep
from repro_torch.models.layers import cdtype, dense_init, rmsnorm, \
    rmsnorm_init
from repro_torch.sharding.rules import axis_size, get_rules, is_dtensor, \
    shard

PyTree = Any
F32 = torch.float32


def moe_init(gen, cfg, device, lead: tuple = ()) -> PyTree:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = cdtype(cfg)
    p = {
        "norm": rmsnorm_init(d, device, lead),
        "router": dense_init(gen, (d, E), d, F32, device, lead),
        "wi": dense_init(gen, (E, d, f), d, dt, device, lead),
        "wu": dense_init(gen, (E, d, f), d, dt, device, lead),
        "wo": dense_init(gen, (E, f, d), f, dt, device, lead),
    }
    if cfg.dense_residual:          # Arctic: a dense MLP beside the experts
        p["dense"] = {
            "wi": dense_init(gen, (d, f), d, dt, device, lead),
            "wu": dense_init(gen, (d, f), d, dt, device, lead),
            "wo": dense_init(gen, (f, d), f, dt, device, lead),
        }
    return p


def capacity(tokens: int, cfg) -> int:
    """Rows an expert takes: ceil(T K / E x capacity factor), at least 1
    (cf >= E / K is dropless)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    return max(int(math.ceil(tokens * K / E * cfg.moe_capacity_factor)), 1)


def _dense_residual(params: PyTree, h: torch.Tensor) -> torch.Tensor:
    """Arctic's dense MLP beside the experts."""
    dp = params["dense"]
    a = F.silu(torch.matmul(h, dp["wi"]))
    return torch.matmul(a * torch.matmul(h, dp["wu"]), dp["wo"])


def moe_apply(params: PyTree, x: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (y in x's dtype, aux f32 scalar)."""
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    if is_dtensor(h):
        rules, _ = get_rules()
        mesh = h.device_mesh
        axis = moe_ep.ep_applicable(cfg, mesh, rules)
        if axis is not None and h.shape[0] % axis_size(mesh, axis) == 0:
            y, aux = moe_ep.moe_apply_ep(params, h, cfg, mesh, axis)
            y = y.redistribute(mesh, h.placements)
            if "dense" in params:
                y = y + _dense_residual(params, h)
            return shard(y, ("batch", "seq", "embed")), aux
        y, aux = _replicated(params, h, cfg)
        if "dense" in params:
            y = y + _dense_residual(params, h)
        return shard(y, ("batch", "seq", "embed")), aux
    y, aux = _dispatch(params, h, cfg)
    if "dense" in params:
        y = y + _dense_residual(params, h)
    return y, aux


def _replicated(params: PyTree, h, cfg):
    """The sort-based dispatch on every rank of h's mesh, over the
    replicated tokens and expert weights (gradients of the local copies
    are the same on every rank: replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = h.device_mesh
    rep = [Replicate()] * mesh.ndim
    local = {k: (v.redistribute(mesh, rep).to_local() if is_dtensor(v)
                 else v) for k, v in params.items() if k != "dense"}
    y, aux = _dispatch(local, h.redistribute(mesh, rep).to_local(), cfg)
    return (DTensor.from_local(y, mesh, rep),
            DTensor.from_local(aux, mesh, rep))


def _dispatch(params: PyTree, h: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sort-based dispatch of the pre-normed h (B, S, D)."""
    B, S, D = h.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    hf = h.reshape(T, D)

    probs = torch.softmax(hf.to(F32) @ params["router"], dim=-1)  # (T, E)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)          # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = expert_idx.reshape(T * K)
    # (not torch.bincount: on a card it reads its input's max back)
    counts = flat_e.new_zeros(E).scatter_add_(0, flat_e,
                                              torch.ones_like(flat_e))
    dispatch_frac = counts.to(F32) / (T * K)
    aux = E * torch.sum(dispatch_frac * probs.mean(dim=0))

    # pack: the picks sorted by expert (stable: within an expert in
    # (token, k) order, which decides the drops), the first `cap` kept
    cap = capacity(T, cfg)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=h.device) - starts[sorted_e]
    dest = torch.where(rank < cap, sorted_e * cap + rank, E * cap)
    buf = h.new_zeros((E * cap + 1, D))
    # one index copy; the drop slot takes every dropped pick and is never
    # read, so its duplicate indices do not matter
    buf.index_copy_(0, dest, hf[sort_idx // K])
    xs = buf[:E * cap].view(E, cap, D)

    # the experts' gated FFN: (E, cap, D) x (E, D, f), then (E, f, D)
    a = F.silu(torch.bmm(xs, params["wi"]))
    ys = torch.bmm(a * torch.bmm(xs, params["wu"]), params["wo"])
    del a

    # combine: pick j's row is at dest[rank of j]; weight by the gates
    ys_flat = torch.cat([ys.reshape(E * cap, D), ys.new_zeros((1, D))])
    inv = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(T * K, device=h.device))
    contrib = ys_flat[dest[inv]].view(T, K, D)
    y = torch.einsum("tkd,tk->td", contrib.to(F32), gate_vals).to(h.dtype)
    return y.reshape(B, S, D), aux
