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
`torch.argsort`, `index_copy_`, `bmm` and indexing. The reference's
expert-parallel branch (`moe_ep`, all-to-all over a mesh) is not ported.

Returns (y, aux): aux is the load-balance loss of Shazeer et al.,
E * sum_e(dispatch fraction_e * mean gate_e), which the trainer adds to
the task loss.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cdtype, dense_init, rmsnorm, \
    rmsnorm_init

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


def moe_apply(params: PyTree, x: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (y in x's dtype, aux f32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
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
    rank = torch.arange(T * K, device=x.device) - starts[sorted_e]
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
        0, sort_idx, torch.arange(T * K, device=x.device))
    contrib = ys_flat[dest[inv]].view(T, K, D)
    y = torch.einsum("tkd,tk->td", contrib.to(F32), gate_vals).to(x.dtype)
    y = y.reshape(B, S, D)

    if "dense" in params:           # Arctic's dense residual
        dp = params["dense"]
        a = F.silu(torch.matmul(h, dp["wi"]))
        y = y + torch.matmul(a * torch.matmul(h, dp["wu"]), dp["wo"])
    return y, aux
