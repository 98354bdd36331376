"""The deadline-driven straggler engine (the JAX package's
`comm/straggler.py`).

  late        a selected upload whose airtime (payload bits over the
              SNR->rate model, `budget.worker_airtime_s`) exceeds
              `round_deadline_s` misses the round. It still spent its
              airtime and advanced the worker's EF residual, but the PS
              cannot fold it into this round's Eq.-7 aggregate.
  buffer      late arrivals are parked, not dropped: one dense decoded
              delta (f32) and an int32 staleness count per worker
              (`StragglerBuffer`). A newer late delta overwrites an
              older one.
  drain       on a later round the parked deltas re-enter the aggregate
              FedBuff-style at weight 1/(1+age)^gamma; gamma = 0 makes a
              drained delta count as an on-time one. Drained rows enter
              median / trimmed-mean order statistics pre-scaled by their
              weight.
  quorum      with fewer than `quorum` deltas available (fresh plus
              drained) the PS holds w_t bitwise, the downlink broadcasts
              the old model, the PS EF residual freezes and the parked
              deltas wait (and age) another round.
  faults      deterministic worker churn: each round every worker starts
              an R-round outage with `fault_prob`. A crashed worker
              transmits nothing.

Random draws are inputs, as everywhere in the port. The fault schedule
must be a pure function of (fault_seed, round), since each round's mask
reads the crash draws of the last R rounds: the crash row of round t
comes from a numpy generator of its own, keyed by (fault_seed,
FAULT_SALT, t) on the host (`crash_draws`), so any round's fleet status
can be recomputed alone; tests inject the reference's rows instead.
The AWGN of the straggler route is always per-upload decode noise, drawn
(C, *leaf) like the robust aggregators' (`channel.noise_shapes`).

With `round_deadline_s=None` no buffer exists (`init_buffer` returns
None) and the wire is the legacy route.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm import budget as comm_budget
from repro_torch.comm import channel as comm_channel
from repro_torch.comm import phy as comm_phy
from repro_torch.comm.budget import CommConfig
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

PyTree = Any

FAULT_SALT = 0xFA    # the fault schedule's own stream, apart from every
#                      training and channel draw


class StragglerBuffer(NamedTuple):
    """Per-worker parked-delta state (leading worker dim C)."""
    delta: PyTree          # (C, ...) f32 decoded deltas (zero when empty)
    age: torch.Tensor      # (C,) int32 rounds since parked; 0 = empty


class StragglerStats(NamedTuple):
    """One round of straggler telemetry (f32 scalars on the device)."""
    late: torch.Tensor      # selected uploads past the deadline
    drained: torch.Tensor   # parked deltas folded into this aggregate
    buffered: torch.Tensor  # buffer occupancy after the round
    held: torch.Tensor      # 1.0 when the quorum held the global model


def active(cfg: CommConfig) -> bool:
    """Is the straggler engine on (a round deadline set)?"""
    return cfg.round_deadline_s is not None


def fault_mode(cfg: CommConfig) -> bool:
    """Is deterministic worker churn on?"""
    return cfg.fault_prob > 0.0


def init_buffer(cfg: CommConfig,
                stacked_params: PyTree) -> Optional[StragglerBuffer]:
    """Zero parked-delta state shaped like the stacked worker models (f32
    whatever the model's dtype), or None while the engine is off."""
    if not active(cfg):
        return None
    delta = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device), stacked_params)
    leaf = tree_flatten(stacked_params)[0][0]
    return StragglerBuffer(delta=delta, age=torch.zeros(
        (leaf.shape[0],), dtype=torch.int32, device=leaf.device))


def crash_draws(cfg: CommConfig, round_idx: int,
                num_workers: int) -> np.ndarray:
    """(R, C) bool crash draws for the rounds t, t - 1, ..., t - R + 1
    (R = fault_rounds; rows of rounds before 0 are False). Row r is
    round t - r's own draw, from a generator keyed by (fault_seed,
    FAULT_SALT, t - r)."""
    rows = np.zeros((cfg.fault_rounds, num_workers), bool)
    for r in range(cfg.fault_rounds):
        t = round_idx - r
        if t >= 0:
            rng = np.random.default_rng([cfg.fault_seed, FAULT_SALT, t])
            rows[r] = rng.random(num_workers) < cfg.fault_prob
    return rows


def alive_mask(crash: torch.Tensor) -> torch.Tensor:
    """(C,) f32 mask of the workers NOT in an outage at round t: a worker
    is down iff it drew a crash in any of the last `fault_rounds` rounds.
    `crash` is the (R, C) draw rows of rounds t .. t - R + 1
    (`crash_draws`; rows of rounds before 0 False)."""
    return (~crash.to(torch.bool).any(dim=0)).to(torch.float32)


def late_mask(cfg: CommConfig, params: PyTree, mask: torch.Tensor,
              snr_db: Optional[torch.Tensor] = None,
              tier_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C,) indicator of the selected uploads whose airtime is strictly
    above `round_deadline_s`: a deep fade or a heavy tier makes a worker
    late, not a coin flip."""
    C = mask.shape[0]
    wb = comm_budget.worker_payload_bytes(cfg, params, C, tier_idx=tier_idx,
                                          device=mask.device)
    snr = (snr_db if snr_db is not None
           else torch.full((C,), cfg.snr_db, dtype=torch.float32,
                           device=mask.device))
    air = comm_budget.worker_airtime_s(cfg, wb, snr)
    return mask * (air > cfg.round_deadline_s).to(mask.dtype)


def staleness_weights(cfg: CommConfig, age: torch.Tensor) -> torch.Tensor:
    """(C,) drain discount 1/(1+age)^gamma for occupied slots, 0 for
    empty ones."""
    occupied = (age > 0).to(torch.float32)
    return occupied * (1.0 + age.to(torch.float32)) ** (-cfg.staleness_gamma)


def _rows(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over a (C, ...) leaf."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def aggregate_and_drain(cfg: CommConfig, global_params: PyTree,
                        wire_deltas: PyTree, mask: torch.Tensor,
                        late: torch.Tensor, snr_db: Optional[torch.Tensor],
                        buffer: StragglerBuffer,
                        keep: Optional[torch.Tensor] = None,
                        noise: Optional[Sequence[torch.Tensor]] = None
                        ) -> tuple[PyTree, torch.Tensor, StragglerBuffer,
                                   StragglerStats]:
    """The straggler Aggregate stage: deliver (`keep`, the erasure draw),
    split fresh from late, drain the buffer at its staleness discounts,
    gate on the quorum and update the parked-delta state. `noise` is the
    per-leaf (C, *leaf) AWGN normals. Returns (w_{t+1}, fresh_mask,
    new_buffer, stats); fresh_mask marks the uploads inside this round's
    aggregate.

    The mean streams leaf by leaf: each leaf's 2C rows (fresh uploads at
    weight 1, drained slots at their discount) are summed over the
    participant count and its buffer slots rewritten before the next
    leaf is decoded, so no whole-model f32 copy of the uploads is held."""
    link = comm_phy.link_model(cfg)
    delivered = comm_phy.delivery_mask(cfg, mask, keep, snr_db=snr_db)
    fresh = delivered * (1.0 - late)
    late_arrivals = delivered * late

    w_drain = staleness_weights(cfg, buffer.age)
    occupied = buffer.age > 0
    n_drain = occupied.to(torch.float32).sum()
    available = fresh.sum() + n_drain
    held = (available < cfg.quorum if cfg.quorum > 0
            else torch.zeros((), dtype=torch.bool, device=mask.device))
    weights = torch.cat([fresh.to(torch.float32), w_drain])
    participants = (weights > 0).to(torch.float32)

    # buffer lifecycle: late arrivals park (newest delta wins the slot, age
    # 1); on a held round fresh arrivals park too and parked slots age one
    # more round; on an applied round every occupied slot drained, so it
    # clears
    parked = (late_arrivals > 0) | (held & (fresh > 0))
    kept = occupied & held & ~parked
    new_age = torch.where(parked, torch.ones_like(buffer.age),
                          torch.where(kept, buffer.age + 1,
                                      torch.zeros_like(buffer.age))
                          ).to(torch.int32)

    g_leaves, treedef = tree_flatten(global_params)
    d_leaves = tree_flatten(wire_deltas)[0]
    b_leaves = tree_flatten(buffer.delta)[0]

    def decode(i: int, d: torch.Tensor) -> torch.Tensor:
        # distortion at arrival time: per-upload digital decode noise (an
        # asynchronous round has no analog superposition to ride)
        d = d.to(torch.float32)
        if link.awgn:
            snr = (snr_db if link.per_worker and snr_db is not None
                   else torch.full((d.shape[0],), cfg.snr_db,
                                   dtype=torch.float32, device=d.device))
            d = d + comm_phy.noise_sigma_per_worker(d, snr) * noise[i]
        return d

    def buf_leaf(d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(_rows(d, parked), d,
                           torch.where(_rows(d, kept), b,
                                       torch.zeros_like(b)))

    out, new_delta, rows_leaves = [], [], []
    denom = torch.clamp(participants.sum(), min=1.0)
    for i, (g, d, b) in enumerate(zip(g_leaves, d_leaves, b_leaves)):
        d = decode(i, d)
        rows = torch.cat([d, b], dim=0)
        rows.mul_(_rows(rows, weights))
        if cfg.aggregator == "mean":
            # FedBuff: the discounted numerator over the participant
            # count; with nothing drained this is the legacy masked mean
            agg = (g + rows.sum(dim=0) / denom).to(g.dtype)
            # quorum hold: w_t survives bitwise
            out.append(torch.where(held, g, agg))
        else:
            rows_leaves.append(rows)
        del rows
        new_delta.append(buf_leaf(d, b))
    if cfg.aggregator != "mean":
        # median / trimmed mean over the pre-weighted rows; the noise is
        # already in, so the robust path runs with distortion off
        agg = comm_channel._robust_receive(
            cfg, link._replace(awgn=False), global_params,
            tree_unflatten(treedef, rows_leaves), participants, None, None)
        out = [torch.where(held, g, a) for g, a in
               zip(g_leaves, tree_flatten(agg)[0])]

    stats = StragglerStats(
        late=(mask * late).sum().to(torch.float32),
        drained=torch.where(held, torch.zeros_like(n_drain), n_drain),
        buffered=(new_age > 0).sum().to(torch.float32),
        held=held.to(torch.float32))
    return (tree_unflatten(treedef, out), fresh,
            StragglerBuffer(delta=tree_unflatten(treedef, new_delta),
                            age=new_age), stats)
