"""Uplink channel + Eq.-7 Aggregate stage, over the phy link model.

  ideal      lossless digital uplink
  erasure    each selected upload lost i.i.d. with `drop_prob`; the
             masked mean shrinks to the survivors, an all-lost round
             leaves w_t unchanged
  awgn       AWGN at the received SNR: on the superposed sum when the
             fleet shares one SNR (analog aggregation), per upload at
             each worker's own SNR otherwise
  composite  erasure and AWGN together

Byzantine workers (the last `byzantine` of C) corrupt their own round
params before the wire, so Eq. 6 can see and reject them.

Random draws are inputs: `keep` (C,) erasure draws, `noise` per-leaf
standard normals shaped by `noise_shapes` (also the straggler engine's,
comm/straggler.py), `byz_noise` per-leaf (C, *leaf) normals for the
gaussian attack.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm import compress as comm_compress
from repro_torch.comm import phy as comm_phy
from repro_torch.comm.budget import CommConfig
from repro_torch.kernels.wire_agg import wire_aggregate
from repro_torch.pytree import tree_flatten, tree_unflatten

PyTree = Any


def corrupt_local_updates(cfg: CommConfig, prev_params: PyTree,
                          new_params: PyTree,
                          byz_noise: Optional[Sequence[torch.Tensor]] = None
                          ) -> PyTree:
    """Replace the last `cfg.byzantine` workers' local updates with the
    attack (sign flip, or prev + byzantine_scale * noise)."""
    if cfg.byzantine <= 0:
        return new_params
    leaves, treedef = tree_flatten(new_params)
    prev_leaves = tree_flatten(prev_params)[0]
    C = leaves[0].shape[0]
    byz = torch.arange(C, device=leaves[0].device) >= C - cfg.byzantine
    out = []
    for i, (new, prev) in enumerate(zip(leaves, prev_leaves)):
        if cfg.byzantine_mode == "sign_flip":
            attacked = 2.0 * prev - new
        else:
            attacked = prev + (cfg.byzantine_scale * byz_noise[i]).to(
                new.dtype)
        m = byz.reshape((-1,) + (1,) * (new.ndim - 1))
        out.append(torch.where(m, attacked.to(new.dtype), new))
    return tree_unflatten(treedef, out)


def noise_shapes(cfg: CommConfig, params: PyTree,
                 num_workers: int) -> Optional[list[tuple]]:
    """Shapes of the per-leaf AWGN draws the Aggregate stage consumes
    (None when the link has no AWGN): (C, *leaf) for per-upload noise —
    robust aggregators, per-worker SNRs, or the straggler engine (an
    asynchronous round has no analog superposition) — else the
    superposed leaf shape."""
    link = comm_phy.link_model(cfg)
    if not link.awgn:
        return None
    per_upload = (cfg.aggregator != "mean" or link.per_worker
                  or cfg.round_deadline_s is not None)
    return [((num_workers,) if per_upload else ()) + tuple(x.shape)
            for x in tree_flatten(params)[0]]


def erasure_mask(cfg: CommConfig, mask: torch.Tensor,
                 keep: Optional[torch.Tensor],
                 snr_db: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Post-channel survivor mask (compat shim over phy.delivery_mask:
    packet erasure, the injected keep draw, composed with SNR outage)."""
    return comm_phy.delivery_mask(cfg, mask, keep, snr_db=snr_db)


def receive(cfg: CommConfig, global_params: PyTree, wire_deltas: PyTree,
            mask: torch.Tensor, keep: Optional[torch.Tensor] = None,
            noise: Optional[Sequence[torch.Tensor]] = None,
            snr_db: Optional[torch.Tensor] = None
            ) -> tuple[PyTree, torch.Tensor]:
    """Push the selected workers' decoded deltas through the link and
    fold the Eq.-7 aggregate into the global model. Returns (w_{t+1},
    mask_eff)."""
    link = comm_phy.link_model(cfg)
    mask_eff = comm_phy.delivery_mask(cfg, mask, keep, snr_db=snr_db)
    if cfg.aggregator != "mean":
        return _robust_receive(cfg, link, global_params, wire_deltas,
                               mask_eff, noise, snr_db), mask_eff
    denom = torch.clamp(mask_eff.sum(), min=1.0)
    g_leaves, treedef = tree_flatten(global_params)
    d_leaves = tree_flatten(wire_deltas)[0]
    out = []
    for i, (g, d) in enumerate(zip(g_leaves, d_leaves)):
        d = d.to(torch.float32)
        m = mask_eff.reshape((-1,) + (1,) * (d.ndim - 1))
        per_worker = link.per_worker and snr_db is not None
        if link.awgn and per_worker:
            d = d + comm_phy.noise_sigma_per_worker(d, snr_db) * noise[i]
        s = (m * d).sum(dim=0)
        if link.awgn and not per_worker:
            s = s + comm_phy.noise_sigma_superposed(cfg, s) * noise[i]
        out.append((g + s / denom).to(g.dtype))
    return tree_unflatten(treedef, out), mask_eff


def receive_packed(cfg: CommConfig, global_params: PyTree,
                   wire: "comm_compress.PackedWire", mask: torch.Tensor,
                   keep: Optional[torch.Tensor] = None,
                   snr_db: Optional[torch.Tensor] = None,
                   weights: Optional[torch.Tensor] = None
                   ) -> tuple[PyTree, torch.Tensor]:
    """Fused-wire sibling of `receive`: the PS decodes the C packed
    payloads of each leaf straight into the Eq.-7 aggregate (one
    wire_agg kernel launch per leaf). No AWGN on this route."""
    mask_eff = comm_phy.delivery_mask(cfg, mask, keep, snr_db=snr_db)
    bits = comm_compress.quant_bits(cfg)
    g_leaves, treedef = tree_flatten(global_params)
    out = []
    for g, p, s in zip(g_leaves, wire.packed, wire.scales):
        agg = wire_aggregate(p, s, mask_eff, shape=tuple(g.shape), bits=bits,
                             aggregator=cfg.aggregator,
                             trim_ratio=cfg.trim_ratio, weights=weights)
        out.append((g + agg).to(g.dtype))
    return tree_unflatten(treedef, out), mask_eff


def _robust_receive(cfg: CommConfig, link: comm_phy.LinkModel,
                    global_params: PyTree, wire_deltas: PyTree,
                    mask_eff: torch.Tensor,
                    noise: Optional[Sequence[torch.Tensor]],
                    snr_db: Optional[torch.Tensor]) -> PyTree:
    """Coordinate-wise median / trimmed mean over the delivered deltas
    (CB-DSL). Lost workers sort to the top at +inf; the survivor count k
    picks the order statistics."""
    k = int(mask_eff.sum().item())
    g_leaves, treedef = tree_flatten(global_params)
    d_leaves = tree_flatten(wire_deltas)[0]
    out = []
    for i, (g, d) in enumerate(zip(g_leaves, d_leaves)):
        C = d.shape[0]
        d = d.to(torch.float32)
        m = mask_eff.reshape((-1,) + (1,) * (d.ndim - 1))
        if link.awgn:
            if link.per_worker and snr_db is not None:
                sigma = comm_phy.noise_sigma_per_worker(d, snr_db)
            else:
                n_el = torch.clamp(mask_eff.sum(), min=1.0) * (d.numel() // C)
                sig_rms = torch.sqrt((m * d * d).sum() / n_el)
                sigma = sig_rms * (10.0 ** (-cfg.snr_db / 20.0))
            d = d + sigma * noise[i]
        svals = torch.sort(torch.where(m > 0, d, torch.full_like(
            d, float("inf"))), dim=0).values
        if k == 0:                        # all-lost round: w_t unchanged
            agg = torch.zeros_like(svals[0])
        elif cfg.aggregator == "median":
            lo = (k - 1) // 2
            agg = 0.5 * (svals[lo] + svals[(k - 1) - lo])
        else:
            t = int(np.float32(cfg.trim_ratio) * np.float32(k))
            t = min(t, (k - 1) // 2)
            agg = svals[t:k - t].sum(dim=0) / float(max(k - 2 * t, 1))
        out.append((g + agg).to(g.dtype))
    return tree_unflatten(treedef, out)
