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
expert axis, the expert-parallel all-to-all dispatch of `moe_ep` runs.
Otherwise the dispatch takes the reference's layout (`_expert_sharded`):
the routing, the stable sort and the pack into the (E * cap + 1, D)
buffer run replicated on every rank, as the reference pins its scatter
and gather; each rank cuts its own experts' rows out of the buffer (a
local slice) and runs the three products against its own weight shards,
wi and wu ("expert", "embed_fsdp", "expert_mlp") and wo ("expert",
"expert_mlp", "embed_fsdp"); where "expert_mlp" takes a mesh axis the
wo product is a partial sum over it, reduced there in f32 and rounded
to the model's dtype once, as the whole product rounds; the expert rows
are then gathered over the expert axis into the replicated buffer for
the combine. No rank holds another rank's expert weights or their
gradients. Arctic's dense residual runs beside either, and the output
is constrained like the reference's.

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
        else:
            y, aux = _expert_sharded(params, h, cfg)
        if "dense" in params:
            y = y + _dense_residual(params, h)
        return shard(y, ("batch", "seq", "embed")), aux
    y, aux = _dispatch(params, h, cfg)
    if "dense" in params:
        y = y + _dense_residual(params, h)
    return y, aux


def route(hf: torch.Tensor, router: torch.Tensor, cfg):
    """(T, D) -> gates (T, K) renormalised, expert ids (T, K), the picks
    of each expert (E,) and the load-balance aux, in f32."""
    T = hf.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(hf.to(F32) @ router, dim=-1)            # (T, E)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)          # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = expert_idx.reshape(T * K)
    # (not torch.bincount: on a card it reads its input's max back)
    counts = flat_e.new_zeros(E).scatter_add_(0, flat_e,
                                              torch.ones_like(flat_e))
    dispatch_frac = counts.to(F32) / (T * K)
    aux = E * torch.sum(dispatch_frac * probs.mean(dim=0))
    return gate_vals, expert_idx, counts, aux


def pack(hf: torch.Tensor, expert_idx: torch.Tensor, counts: torch.Tensor,
         cfg) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The picks sorted by expert (stable: within an expert in (token, k)
    order, which decides the drops), the first `cap` of each kept.
    Returns the (E, cap, D) expert inputs (a view of the (E * cap + 1, D)
    buffer), each sorted pick's row in the buffer (`dest`, E * cap for a
    dropped one) and the sort."""
    T, D = hf.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    flat_e = expert_idx.reshape(T * K)
    cap = capacity(T, cfg)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=hf.device) - starts[sorted_e]
    dest = torch.where(rank < cap, sorted_e * cap + rank, E * cap)
    buf = hf.new_zeros((E * cap + 1, D))
    # one index copy; the drop slot takes every dropped pick and is never
    # read, so its duplicate indices do not matter
    buf.index_copy_(0, dest, hf[sort_idx // K])
    return buf[:E * cap].view(E, cap, D), dest, sort_idx


def expert_ffn(xs: torch.Tensor, wi: torch.Tensor, wu: torch.Tensor,
               wo: torch.Tensor, partial: bool = False) -> torch.Tensor:
    """The experts' gated FFN: (E, cap, D) x (E, D, f), then (E, f, D).
    `partial`: wi, wu and wo hold a part of the f columns, and the last
    product is a partial sum over them, returned in f32 so that the sum
    over the parts rounds once, as the whole product does."""
    a = F.silu(torch.bmm(xs, wi))
    a = a * torch.bmm(xs, wu)
    if partial:
        return torch.bmm(a.to(F32), wo.to(F32))
    return torch.bmm(a, wo)


def combine(ys: torch.Tensor, dest: torch.Tensor, sort_idx: torch.Tensor,
            gate_vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The (E, cap, D) expert rows -> (T, D): pick j's row is at
    dest[rank of j] (the drop slot a zero row), weighted by its gate in
    f32 and summed over k."""
    T, K = gate_vals.shape
    D = ys.shape[-1]
    ys_flat = torch.cat([ys.reshape(-1, D), ys.new_zeros((1, D))])
    inv = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(T * K, device=ys.device))
    contrib = ys_flat[dest[inv]].view(T, K, D)
    return torch.einsum("tkd,tk->td", contrib.to(F32), gate_vals).to(dtype)


def _dispatch(params: PyTree, h: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sort-based dispatch of the pre-normed h (B, S, D)."""
    B, S, D = h.shape
    hf = h.reshape(B * S, D)
    gate_vals, expert_idx, counts, aux = route(hf, params["router"], cfg)
    xs, dest, sort_idx = pack(hf, expert_idx, counts, cfg)
    ys = expert_ffn(xs, params["wi"], params["wu"], params["wo"])
    y = combine(ys, dest, sort_idx, gate_vals, h.dtype)
    return y.reshape(B, S, D), aux


def _expert_sharded(params: PyTree, h, cfg):
    """The dispatch on h's mesh in the reference's layout (moe.py:107-127
    there): routing, sort, pack and combine replicated on every rank, the
    expert products on the rank's own expert and expert_mlp shards.
    Returns (y, aux) as replicated DTensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.sharding import collectives
    mesh = h.device_mesh
    rep = [Replicate()] * mesh.ndim
    B, S, D = h.shape
    E = cfg.num_experts
    w = {k: shard(params[k], names) for k, names in (
        ("wi", ("expert", "embed_fsdp", "expert_mlp")),
        ("wu", ("expert", "embed_fsdp", "expert_mlp")),
        ("wo", ("expert", "expert_mlp", "embed_fsdp")))}
    pl = w["wi"].placements if is_dtensor(w["wi"]) else rep
    experts = collectives.shard_dims(pl, 0)
    mlp = collectives.shard_dims(pl, 2)

    def local(x, f_dim: int):
        # the rank's experts and f columns, the embed dim whole (gathered
        # where FSDP shards it); its gradient is this shard's, whole
        if not is_dtensor(x):
            return x
        return x.redistribute(mesh, [
            Shard(0) if m in experts else Shard(f_dim) if m in mlp
            else Replicate() for m in range(mesh.ndim)]).to_local()

    hf = h.redistribute(mesh, rep).to_local().reshape(B * S, D)
    router = params["router"]
    if is_dtensor(router):
        router = router.redistribute(mesh, rep).to_local()
    gate_vals, expert_idx, counts, aux = route(hf, router, cfg)
    # each rank's experts see a part of the tokens' gradient: summed
    xs, dest, sort_idx = pack(collectives.sum_grad(hf, mesh, experts + mlp),
                              expert_idx, counts, cfg)
    lo, n = collectives.offset(E, mesh, experts)
    ys = expert_ffn(xs[lo:lo + n], local(w["wi"], 2), local(w["wu"], 2),
                    local(w["wo"], 1), partial=bool(mlp))
    ys = collectives.gather_sum(ys, mesh, experts, mlp, h.dtype)
    y = combine(ys, dest, sort_idx, gate_vals, h.dtype).reshape(B, S, D)
    return (DTensor.from_local(y, mesh, rep, run_check=False),
            DTensor.from_local(aux, mesh, rep, run_check=False))
