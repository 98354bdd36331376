"""Composable round engine: Algorithm 1 as a pipeline of stages over
stacked-worker pytrees (leading dim C).

  LocalUpdate    engine-specific (core/mdsl.py, core/swarm_dist.py)
  ScoreSelect    Eq. 5 scores + Eq. 6 selection (`score_select`), and
                 the round's selection counts (`Selection`)
  Uplink         fault deselection, fading, then per-worker compression
                 with error feedback (`uplink`, or the fused wire-format
                 `uplink_packed`)
  Aggregate      phy link + Eq. 7 (`comm.channel.receive` /
                 `receive_packed`)
  Downlink       the PS broadcast, optionally quantized with PS-side
                 error feedback (`downlink`), and the round's wire
                 accounting
  BestTracking   Eq. 9/10 (core/pso.py for the paper engine;
                 `track_local_best` / `track_global_best` here for the
                 mesh engine's stacked state)

`wire_round` is the one Uplink -> Aggregate -> Downlink block, with the
JAX package's three routes: the fused packed route (int8/int4, one
tier, no AWGN, no deadline — the quant_pack_ef and wire_agg kernels),
the straggler route (a round deadline: the dense uplink, then a
Straggle stage and `comm.straggler.aggregate_and_drain`) and the dense
route. Fault injection (`fault_prob`) deselects crashed workers before
any of them.

Random draws are inputs: `wire_round` reads the uplink/downlink seeds,
the erasure keep draw, the fading normals, the AWGN noise and the fault
schedule's crash rows from the round's `RoundDraws` (core/mdsl.py).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.comm import budget as comm_budget
from repro_torch.comm import channel as comm_channel
from repro_torch.comm import compress as comm_compress
from repro_torch.comm import phy as comm_phy
from repro_torch.comm import straggler as comm_straggler
from repro_torch.comm.budget import CommConfig
from repro_torch.comm.phy import PhyState
from repro_torch.core import selection
from repro_torch.core.selection import SelectionState
from repro_torch.obs.trace import stage_span
from repro_torch.pytree import (tree_flatten, tree_leaves, tree_map,
                                tree_unflatten)

PyTree = Any


class RoundTelemetry(NamedTuple):
    """Per-round telemetry, field for field the JAX package's."""
    losses: torch.Tensor             # (C,) F_{i,t+1} on D_g
    theta: torch.Tensor              # (C,) Eq.-5 scores
    mask: torch.Tensor               # (C,) Eq.-6 selection
    global_loss: torch.Tensor        # () F(w_{t+1}; D_g)
    selected_count: torch.Tensor
    uploaded_params: torch.Tensor
    bytes_up: torch.Tensor
    bytes_down: torch.Tensor
    delivered: torch.Tensor
    compression_ratio: torch.Tensor
    airtime_s: torch.Tensor
    energy_j: torch.Tensor
    mean_snr_db: torch.Tensor
    # (K,) int device ids seated this round by the population engine
    # (core/population.py); None on full-fleet runs
    cohort: Any = None
    # straggler scalars (comm.straggler); None unless round_deadline_s
    late: Any = None          # () selected uploads past the deadline
    drained: Any = None       # () parked deltas folded in this round
    buffered: Any = None      # () buffer occupancy after the round
    held: Any = None          # () 1.0 on a quorum-hold round
    # () workers that transmitted (selected minus crashed); None unless
    # fault injection is on
    transmitted: Any = None

    @property
    def eval_losses(self) -> torch.Tensor:
        return self.losses

    @property
    def delivered_count(self) -> torch.Tensor:
        return self.delivered


class Selection(NamedTuple):
    """ScoreSelect's outputs: the scores, the mask, the next threshold
    and the round's selection counts for the telemetry."""
    theta: torch.Tensor              # (C,) Eq.-5 scores
    mask: torch.Tensor               # (C,) Eq.-6 selection
    theta_mean: torch.Tensor         # () the next round's threshold
    selected_count: torch.Tensor     # () sum of the mask
    uploaded_params: torch.Tensor    # () n * sum of the mask


class WireOutcome(NamedTuple):
    """Result of the Uplink -> Aggregate -> Downlink chain."""
    global_params: PyTree
    residual: PyTree
    ps_residual: PyTree
    mask_eff: torch.Tensor
    record: comm_budget.CommRecord
    phy: Any = None
    buffer: Any = None        # advanced StragglerBuffer (None: no deadline)
    straggler: Any = None     # StragglerStats (None: no deadline)
    transmitted: Any = None   # () transmitting workers (None: no faults)


# ---------------------------------------------------------------------------
# ScoreSelect
# ---------------------------------------------------------------------------

def score_select(algorithm: str, losses: torch.Tensor, eta: torch.Tensor,
                 tau: float, prev_theta_mean: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eq. 5 scores + the per-algorithm rule: fedavg selects everyone,
    dsl the single best, multi_dsl/mdsl the Eq.-6 threshold. Returns
    (theta, mask, new_theta_mean)."""
    if algorithm == "mdsl":
        theta = selection.tradeoff_scores(losses, eta, tau)
    else:
        theta = losses
    if algorithm == "fedavg":
        return theta, torch.ones_like(theta), theta.mean()
    if algorithm == "dsl":
        return theta, selection.one_hot_argmin(theta), theta.mean()
    mask, sel = selection.select_workers(
        theta, SelectionState(prev_theta_mean=prev_theta_mean))
    return theta, mask, sel.prev_theta_mean


# ---------------------------------------------------------------------------
# Uplink
# ---------------------------------------------------------------------------

def tier_masks(comm: CommConfig, theta: torch.Tensor,
               snr_db: Optional[torch.Tensor] = None
               ) -> tuple[tuple[CommConfig, ...], Optional[torch.Tensor]]:
    """Adaptive bits: tier t covers ranks [ceil(C t / T), ceil(C (t+1) /
    T)) of the Eq.-5 score (lower = better) or the SNR (higher =
    better). Returns (tiers, (C,) int32 tier index or None)."""
    tiers = comm_budget.uplink_tiers(comm)
    if len(tiers) == 1:
        return tiers, None
    C = theta.shape[0]
    key = (-snr_db if comm.tier_rank == "snr" and snr_db is not None
           else theta)
    rank = torch.argsort(torch.argsort(key, stable=True), stable=True)
    tier_idx = torch.zeros((C,), dtype=torch.int32, device=theta.device)
    for t in range(1, len(tiers)):
        tier_idx = tier_idx + (rank >= -(-C * t // len(tiers))).to(
            torch.int32)
    return tiers, tier_idx


def uplink(comm: CommConfig, delta: PyTree, residual: PyTree,
           theta: torch.Tensor, mask: torch.Tensor, seeds: torch.Tensor, *,
           snr_db: Optional[torch.Tensor] = None
           ) -> tuple[PyTree, PyTree, Optional[torch.Tensor]]:
    """Dense uplink: compress each worker's delta (+ EF), per-worker
    tiers resolved. seeds: (C, L) int32. Returns (wire, new_residual,
    tier_idx)."""
    tiers, tier_idx = tier_masks(comm, theta, snr_db)
    wire, new_res = comm_compress.compress_with_ef(tiers[0], delta, residual,
                                                   seeds)
    for t in range(1, len(tiers)):
        w_t, r_t = comm_compress.compress_with_ef(tiers[t], delta, residual,
                                                  seeds)

        def pick(a, b, t=t):
            return tree_map(lambda x, y: torch.where(
                (tier_idx == t).reshape((-1,) + (1,) * (x.ndim - 1)), y, x),
                a, b)

        wire, new_res = pick(wire, w_t), pick(new_res, r_t)
    return (wire, comm_compress.select_residual(mask, new_res, residual),
            tier_idx)


def uplink_packed(comm: CommConfig, delta: PyTree, residual: PyTree,
                  mask: torch.Tensor, seeds: torch.Tensor
                  ) -> tuple[comm_compress.PackedWire, PyTree]:
    """Fused uplink: one quantize + pack + EF kernel launch per leaf for
    all workers, emitting stacked packed payloads."""
    wire, new_res = comm_compress.compress_with_ef_packed(comm, delta,
                                                          residual, seeds)
    return wire, comm_compress.select_residual(mask, new_res, residual)


# ---------------------------------------------------------------------------
# Downlink
# ---------------------------------------------------------------------------

def downlink(comm: CommConfig, agg_params: PyTree, prev_broadcast: PyTree,
             ps_residual: PyTree, seeds: torch.Tensor
             ) -> tuple[PyTree, PyTree]:
    """Broadcast the global update. With a downlink compressor the PS
    quantizes the global delta with its own EF residual and workers
    decode w_t + decoded delta. seeds: (L,) int32. Returns
    (broadcast_params, new_ps_residual)."""
    if comm.downlink_compressor == "identity":
        return agg_params, ps_residual
    dcfg = comm_budget.downlink_config(comm)
    delta = tree_map(lambda a, b: (a - b).to(torch.float32)[None],
                     agg_params, prev_broadcast)
    res1 = tree_map(lambda r: r[None], ps_residual)
    wire, new_res = comm_compress.compress_with_ef(dcfg, delta, res1,
                                                   seeds[None])
    bcast = tree_map(lambda g, w: (g + w[0]).to(g.dtype), prev_broadcast,
                     wire)
    return bcast, tree_map(lambda r: r[0], new_res)


def init_ps_residual(params: PyTree) -> PyTree:
    return comm_compress.init_residual(params)


# ---------------------------------------------------------------------------
# the one Eq.-7-through-the-wire block
# ---------------------------------------------------------------------------

def wire_round(comm: CommConfig, *, delta: PyTree, theta: torch.Tensor,
               mask: torch.Tensor, global_params: PyTree, residual: PyTree,
               ps_residual: PyTree, draws, num_workers: int,
               phy: Optional[PhyState] = None, buffer: Any = None,
               uplink_fn: Callable = uplink,
               aggregate_fn: Callable = comm_channel.receive,
               downlink_fn: Callable = downlink) -> WireOutcome:
    """Uplink -> Aggregate -> Downlink with byte/airtime accounting.

    `phy` evolves first (one block-fading draw per round) and the round
    runs against the evolved SNRs. The fused packed route runs when the
    Uplink/Aggregate stages are the defaults and the config qualifies
    (`compress.packed_wire_eligible`). With `round_deadline_s` set, a
    Straggle stage between the dense Uplink and the Aggregate derives
    deadline misses from each upload's airtime, parks late deltas in
    `buffer`, drains parked ones at the FedBuff discount, and holds w_t
    (the broadcast and the PS residual with it) bitwise when fewer than
    `quorum` deltas are available. With `fault_prob` > 0 the workers
    the round's crash rows (`draws.crash`) put in an outage are
    deselected before the uplink."""
    straggler_mode = comm_straggler.active(comm)
    if straggler_mode and (uplink_fn is not uplink
                           or aggregate_fn is not comm_channel.receive):
        raise ValueError(
            "round_deadline_s replaces the Aggregate stage with the "
            "straggler engine; it cannot compose with injected "
            "uplink/aggregate stage functions")
    if straggler_mode and buffer is None:
        raise ValueError(
            "straggler mode needs the parked-delta state: init the engine "
            "with comm.straggler.init_buffer and thread it through "
            "wire_round(buffer=...)")
    transmitted = None
    sstats = None
    with stage_span("Uplink"):
        if comm_straggler.fault_mode(comm):
            if draws.crash is None:
                raise ValueError("fault injection (fault_prob > 0) needs "
                                 "the round's crash rows in draws.crash "
                                 "(comm.straggler.crash_draws)")
            # crashed workers transmit nothing: no bytes, no airtime, no
            # EF advance
            mask = mask * comm_straggler.alive_mask(draws.crash)
            transmitted = mask.sum()
        if phy is not None:
            phy = comm_phy.evolve(comm, phy, draws.fade)
            snr_db = phy.snr_db
        else:
            snr_db = None
        packed_route = (uplink_fn is uplink
                        and aggregate_fn is comm_channel.receive
                        and comm_compress.packed_wire_eligible(comm, delta))
        if packed_route:
            wire, residual = uplink_packed(comm, delta, residual, mask,
                                           draws.up_seeds)
            tier_idx = None
        else:
            # the straggler route always runs the dense uplink: parking a
            # late delta needs its individual decode
            wire, residual, tier_idx = uplink_fn(comm, delta, residual,
                                                 theta, mask, draws.up_seeds,
                                                 snr_db=snr_db)
    if packed_route:
        with stage_span("Aggregate"):
            agg_params, mask_eff = comm_channel.receive_packed(
                comm, global_params, wire, mask, keep=draws.keep,
                snr_db=snr_db)
    elif straggler_mode:
        with stage_span("Straggle"):
            late = comm_straggler.late_mask(comm, global_params, mask,
                                            snr_db=snr_db, tier_idx=tier_idx)
        with stage_span("Aggregate"):
            agg_params, mask_eff, buffer, sstats = (
                comm_straggler.aggregate_and_drain(
                    comm, global_params, wire, mask, late, snr_db, buffer,
                    keep=draws.keep, noise=draws.noise))
    else:
        with stage_span("Aggregate"):
            agg_params, mask_eff = aggregate_fn(
                comm, global_params, wire, mask, keep=draws.keep,
                noise=draws.noise, snr_db=snr_db)
    with stage_span("Downlink"):
        bcast, ps_res_new = downlink_fn(comm, agg_params, global_params,
                                        ps_residual, draws.down_seeds)
        if straggler_mode:
            # quorum hold: the PS broadcasts w_t unchanged and its downlink
            # EF state freezes (a compressed downlink would otherwise
            # flush its residual through a zero aggregate)
            held = sstats.held > 0
            bcast = tree_map(lambda g, b: torch.where(held, g, b),
                             global_params, bcast)
            ps_residual = tree_map(lambda o, n: torch.where(held, o, n),
                                   ps_residual, ps_res_new)
        else:
            ps_residual = ps_res_new
        rec = comm_budget.round_record(comm, global_params, num_workers,
                                       mask, mask_eff, tier_idx=tier_idx,
                                       snr_db=snr_db)
        if phy is not None:
            phy = comm_phy.advance_age(
                phy, mask_eff,
                buffered=buffer.age if straggler_mode else None)
    return WireOutcome(global_params=bcast, residual=residual,
                       ps_residual=ps_residual, mask_eff=mask_eff,
                       record=rec, phy=phy, buffer=buffer,
                       straggler=sstats, transmitted=transmitted)


# ---------------------------------------------------------------------------
# BestTracking stage (Eqs. 9/10, stacked form used by the mesh engine;
# the paper engine keeps its WorkerState-shaped pso.update_*_best)
# ---------------------------------------------------------------------------

def where_rows(cond: torch.Tensor, new: torch.Tensor,
               old: torch.Tensor) -> torch.Tensor:
    """Per worker: new where cond (W,), else old."""
    return torch.where(cond.reshape((-1,) + (1,) * (new.ndim - 1)), new,
                       old)


def track_local_best(best_params: PyTree, best_loss: torch.Tensor,
                     params: PyTree, losses: torch.Tensor, *,
                     where: Callable = where_rows
                     ) -> tuple[PyTree, torch.Tensor]:
    """Eq. 9 over stacked workers: keep each worker's best-F params.
    `where(improved, new, old)` picks the rows of a stacked leaf (a mesh
    engine passes its layout's)."""
    improved = losses < best_loss
    return (tree_map(lambda n, o: where(improved, n, o), params,
                     best_params),
            torch.where(improved, losses, best_loss))


def track_global_best(gbest_params: PyTree, gbest_loss: torch.Tensor,
                      params: PyTree, loss: torch.Tensor, *,
                      where: Callable = torch.where
                      ) -> tuple[PyTree, torch.Tensor]:
    """Eq. 10: keep the best global model seen so far."""
    improved = loss < gbest_loss
    return (tree_map(lambda n, o: where(improved, n, o), params,
                     gbest_params),
            torch.minimum(loss, gbest_loss))


# ---------------------------------------------------------------------------
# shared LocalUpdate helper
# ---------------------------------------------------------------------------

def accumulated_grad(grad_fn: Callable, params: PyTree, batch: PyTree,
                     microbatches: int) -> PyTree:
    """Gradient of one local batch, optionally accumulated over
    microbatch chunks of the leading batch dim (f32 accumulator, then
    the mean cast back to each param's dtype) to bound activation
    memory. `grad_fn(params, batch) -> grads`."""
    if microbatches <= 1:
        return grad_fn(params, batch)
    k = microbatches
    f32 = torch.float32
    # laid out as each param (a DTensor param's accumulator is its shards,
    # not a whole leaf on every rank)
    total = tree_map(lambda x: torch.zeros_like(x, dtype=f32), params)
    leaves, treedef = tree_flatten(batch)
    chunks = [_chunked(x, k) for x in leaves]
    for i in range(k):
        mb = tree_unflatten(treedef, [c[i] for c in chunks])
        total = tree_map(lambda s, g: s + g.to(f32), total,
                         grad_fn(params, mb))
    return tree_map(lambda g, p: (g / k).to(p.dtype), total, params)


def _chunked(x: torch.Tensor, k: int):
    """x's leading dim as k contiguous chunks: a (k, n / k, ...) view, or
    for a DTensor whose row shards straddle the chunks (k chunks over
    more shards than divide k; an FSDP worker's batch on a 16-way data
    axis), the list of chunks cut from the rows gathered over those
    shards (token ids: a small copy), each laid out as x was."""
    from repro_torch.sharding.rules import is_dtensor
    rows = x.shape[0] // k
    if is_dtensor(x):
        mesh, pl = x.device_mesh, tuple(x.placements)
        shards = 1
        for m, p in enumerate(pl):
            if p.is_shard(0):
                shards *= mesh.size(m)
        if shards > 1 and k % shards:
            from torch.distributed.tensor import Replicate
            whole = x.redistribute(mesh, [Replicate() if p.is_shard(0)
                                          else p for p in pl])
            parts = [whole[i * rows:(i + 1) * rows] for i in range(k)]
            return [p.redistribute(mesh, pl) if rows % shards == 0 else p
                    for p in parts]
    return x.reshape((k, rows) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# the pipeline object
# ---------------------------------------------------------------------------

class RoundPipeline(NamedTuple):
    """Static round configuration + the stage functions."""
    algorithm: str
    comm: CommConfig
    num_workers: int
    tau: float = 0.9
    n_params: int = 0
    score_select_fn: Callable = score_select
    uplink_fn: Callable = uplink
    aggregate_fn: Callable = comm_channel.receive
    downlink_fn: Callable = downlink

    def select(self, losses, eta, prev_theta_mean) -> Selection:
        with stage_span("ScoreSelect"):
            theta, mask, theta_mean = self.score_select_fn(
                self.algorithm, losses, eta, self.tau, prev_theta_mean)
            return Selection(theta=theta, mask=mask, theta_mean=theta_mean,
                             selected_count=mask.sum(),
                             uploaded_params=(
                                 selection.uploaded_parameter_count(
                                     mask, self.n_params)))

    def wire(self, *, delta, theta, mask, global_params, residual,
             ps_residual, draws, phy=None, buffer=None) -> WireOutcome:
        return wire_round(self.comm, delta=delta, theta=theta, mask=mask,
                          global_params=global_params, residual=residual,
                          ps_residual=ps_residual, draws=draws,
                          num_workers=self.num_workers, phy=phy,
                          buffer=buffer,
                          uplink_fn=self.uplink_fn,
                          aggregate_fn=self.aggregate_fn,
                          downlink_fn=self.downlink_fn)

    def telemetry(self, *, losses, sel: Selection, global_loss,
                  outcome: WireOutcome) -> RoundTelemetry:
        """The round's record from the stages' outputs: it launches no
        device work."""
        rec = outcome.record
        s = outcome.straggler
        return RoundTelemetry(
            losses=losses, theta=sel.theta, mask=sel.mask,
            global_loss=global_loss, selected_count=sel.selected_count,
            uploaded_params=sel.uploaded_params,
            bytes_up=rec.bytes_up, bytes_down=rec.bytes_down,
            delivered=rec.delivered,
            compression_ratio=rec.compression_ratio,
            airtime_s=rec.airtime_s, energy_j=rec.energy_j,
            mean_snr_db=rec.mean_snr_db,
            **({} if s is None else s._asdict()),
            transmitted=outcome.transmitted)


def count_params(params: PyTree) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))
