"""Uplink compressors with error feedback, over stacked workers.

A compressor maps each worker's round delta to what the parameter server
decodes from the wire, while `budget.payload_bytes` charges the wire
cost:

  identity  the delta itself
  topk      the k = max(1, floor(ratio*n)) largest-|.| entries per leaf
  int8/int4 block-scaled stochastic quantization through the
            kernels/quant_pack kernels

Error feedback: each worker carries a residual of what its past uploads
dropped; round t compresses delta_t + e_t and keeps the new error. Only
workers whose upload was attempted (Eq.-6 selected) advance it.

Every leaf carries a leading worker dim C (the downlink passes C = 1),
and the int8/int4 seeds are an explicit (C, L) int32 draw — leaf l of
worker c rounds with seeds[c, l].
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.comm.budget import CommConfig, topk_count
from repro_torch.comm.phy import link_model
from repro_torch.kernels.quant_pack import quant_dequant, quantize_pack_ef
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

PyTree = Any

_QUANT_BITS = {"int8": 8, "int4": 4}


def _topk_leaf(x: torch.Tensor, k: int) -> torch.Tensor:
    """Dense decode of top-k per worker: the k largest-|.| entries
    survive, the rest are zero."""
    C = x.shape[0]
    flat = x.reshape(C, -1).to(torch.float32)
    idx = torch.topk(flat.abs(), k, dim=1).indices
    wire = torch.zeros_like(flat).scatter_(1, idx, flat.gather(1, idx))
    return wire.reshape(x.shape).to(x.dtype)


def compress(cfg: CommConfig, tree: PyTree,
             seeds: torch.Tensor) -> PyTree:
    """Stacked uplink: pytree -> decoded-payload pytree. seeds (C, L)."""
    if cfg.compressor == "identity":
        return tree
    leaves, treedef = tree_flatten(tree)
    if cfg.compressor == "topk":
        out = [_topk_leaf(x, topk_count(x[0].numel(), cfg.topk_ratio))
               for x in leaves]
    else:
        bits = _QUANT_BITS[cfg.compressor]
        out = [quant_dequant(x.to(torch.float32), seeds[:, i].contiguous(),
                             bits=bits).to(x.dtype)
               for i, x in enumerate(leaves)]
    return tree_unflatten(treedef, out)


def compress_with_ef(cfg: CommConfig, delta: PyTree, residual: PyTree,
                     seeds: torch.Tensor) -> tuple[PyTree, PyTree]:
    """Compress delta + residual; returns (wire, new_residual). With
    error feedback off the residual stays zero."""
    if cfg.error_feedback:
        acc = tree_map(lambda d, r: d + r.to(d.dtype), delta, residual)
    else:
        acc = delta
    wire = compress(cfg, acc, seeds)
    if cfg.error_feedback:
        new_residual = tree_map(lambda a, w: (a - w).to(torch.float32),
                                acc, wire)
    else:
        new_residual = tree_map(torch.zeros_like, residual)
    return wire, new_residual


class PackedWire(NamedTuple):
    """Stacked uplink in wire format: per-leaf packed planes (C, ...) and
    per-block scales (C, nb), aligned with the delta's leaves."""
    packed: tuple
    scales: tuple


def quant_bits(cfg: CommConfig) -> Optional[int]:
    """Wire bit width of a quantizing compressor (None otherwise)."""
    return _QUANT_BITS.get(cfg.compressor)


def packed_wire_eligible(cfg: CommConfig, tree: PyTree) -> bool:
    """True when the fused wire-format route applies: int8/int4 uplink at
    one fleet-wide tier, no deadline, no AWGN (value distortion), and f32
    leaves."""
    if quant_bits(cfg) is None or cfg.adaptive_bits:
        return False
    if cfg.round_deadline_s is not None:
        return False
    if link_model(cfg).awgn:
        return False
    return all(x.dtype == torch.float32 for x in tree_flatten(tree)[0])


def compress_with_ef_packed(cfg: CommConfig, delta: PyTree, residual: PyTree,
                            seeds: torch.Tensor
                            ) -> tuple[PackedWire, PyTree]:
    """Fused-wire sibling of `compress_with_ef`: one quantize + pack + EF
    kernel launch per leaf for all C workers. Returns (PackedWire,
    new_residual)."""
    bits = quant_bits(cfg)
    leaves, treedef = tree_flatten(delta)
    res_leaves = tree_flatten(residual)[0]
    packed, scales, new_res = [], [], []
    for i, (x, r) in enumerate(zip(leaves, res_leaves)):
        r_in = r if cfg.error_feedback else torch.zeros_like(r)
        p, s, res = quantize_pack_ef(x, r_in, seeds[:, i].contiguous(),
                                     bits=bits)
        packed.append(p)
        scales.append(s)
        new_res.append(res if cfg.error_feedback else torch.zeros_like(res))
    return (PackedWire(tuple(packed), tuple(scales)),
            tree_unflatten(treedef, new_res))


def init_residual(params: PyTree) -> PyTree:
    """Zero error-feedback state shaped like `params` (f32)."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)


def select_residual(mask: torch.Tensor, new_residual: PyTree,
                    old_residual: PyTree) -> PyTree:
    """Advance residuals only for workers whose upload was attempted."""
    def leaf(n, o):
        m = mask.reshape((-1,) + (1,) * (n.ndim - 1))
        return torch.where(m > 0, n, o)

    return tree_map(leaf, new_residual, old_residual)
