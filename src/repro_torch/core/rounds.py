"""Composable round engine: Algorithm 1 as a pipeline of stages over
stacked-worker pytrees (leading dim C).

  LocalUpdate    engine-specific (core/mdsl.py)
  ScoreSelect    Eq. 5 scores + Eq. 6 selection (`score_select`)
  Uplink         per-worker compression with error feedback (`uplink`,
                 or the fused wire-format `uplink_packed`)
  Aggregate      phy link + Eq. 7 (`comm.channel.receive` /
                 `receive_packed`)
  Downlink       the PS broadcast, optionally quantized with PS-side
                 error feedback (`downlink`)
  BestTracking   Eq. 9/10 (core/pso.py for the paper engine;
                 `track_local_best` / `track_global_best` here for the
                 mesh engine's stacked state)

`wire_round` is the one Uplink -> Aggregate -> Downlink block, with the
JAX package's three routes: the fused packed route (int8/int4, one
tier, no AWGN — the quant_pack_ef and wire_agg kernels), the straggler
route (not ported yet: raises) and the dense route.

Random draws are inputs: `wire_round` reads the uplink/downlink seeds,
the erasure keep draw, the fading normals and the AWGN noise from the
round's `RoundDraws` (core/mdsl.py).
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
from repro_torch.pytree import tree_leaves, tree_map

PyTree = Any

# a named range per stage: free unless a torch.profiler session is
# recording, where it groups the stage's host and device time
stage_span = torch.profiler.record_function


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
    # the JAX package's trailing population/straggler fields (cohort,
    # late, drained, buffered, held, transmitted) come with those engines

    @property
    def eval_losses(self) -> torch.Tensor:
        return self.losses

    @property
    def delivered_count(self) -> torch.Tensor:
        return self.delivered


class WireOutcome(NamedTuple):
    """Result of the Uplink -> Aggregate -> Downlink chain."""
    global_params: PyTree
    residual: PyTree
    ps_residual: PyTree
    mask_eff: torch.Tensor
    record: comm_budget.CommRecord
    phy: Any = None
    buffer: Any = None


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
               round_idx: Optional[int] = None,
               uplink_fn: Callable = uplink,
               aggregate_fn: Callable = comm_channel.receive,
               downlink_fn: Callable = downlink) -> WireOutcome:
    """Uplink -> Aggregate -> Downlink with byte/airtime accounting.

    `phy` evolves first (one block-fading draw per round) and the round
    runs against the evolved SNRs. The fused packed route runs when the
    Uplink/Aggregate stages are the defaults and the config qualifies
    (`compress.packed_wire_eligible`); the straggler route (a round
    deadline or fault injection) is not ported and raises."""
    comm_straggler.require_off(comm)
    if phy is not None:
        phy = comm_phy.evolve(comm, phy, draws.fade)
        snr_db = phy.snr_db
    else:
        snr_db = None
    packed_route = (uplink_fn is uplink
                    and aggregate_fn is comm_channel.receive
                    and comm_compress.packed_wire_eligible(comm, delta))
    if packed_route:
        with stage_span("Uplink"):
            wire, residual = uplink_packed(comm, delta, residual, mask,
                                           draws.up_seeds)
            tier_idx = None
        with stage_span("Aggregate"):
            agg_params, mask_eff = comm_channel.receive_packed(
                comm, global_params, wire, mask, keep=draws.keep,
                snr_db=snr_db)
    else:
        with stage_span("Uplink"):
            wire, residual, tier_idx = uplink_fn(comm, delta, residual,
                                                 theta, mask, draws.up_seeds,
                                                 snr_db=snr_db)
        with stage_span("Aggregate"):
            agg_params, mask_eff = aggregate_fn(
                comm, global_params, wire, mask, keep=draws.keep,
                noise=draws.noise, snr_db=snr_db)
    with stage_span("Downlink"):
        bcast, ps_residual = downlink_fn(comm, agg_params, global_params,
                                         ps_residual, draws.down_seeds)
    rec = comm_budget.round_record(comm, global_params, num_workers, mask,
                                   mask_eff, tier_idx=tier_idx,
                                   snr_db=snr_db)
    if phy is not None:
        phy = comm_phy.advance_age(phy, mask_eff)
    return WireOutcome(global_params=bcast, residual=residual,
                       ps_residual=ps_residual, mask_eff=mask_eff,
                       record=rec, phy=phy, buffer=buffer)


# ---------------------------------------------------------------------------
# BestTracking stage (Eqs. 9/10, stacked form used by the mesh engine;
# the paper engine keeps its WorkerState-shaped pso.update_*_best)
# ---------------------------------------------------------------------------

def track_local_best(best_params: PyTree, best_loss: torch.Tensor,
                     params: PyTree, losses: torch.Tensor
                     ) -> tuple[PyTree, torch.Tensor]:
    """Eq. 9 over stacked workers: keep each worker's best-F params."""
    improved = losses < best_loss

    def leaf(n, o):
        return torch.where(improved.reshape((-1,) + (1,) * (n.ndim - 1)),
                           n, o)

    return (tree_map(leaf, params, best_params),
            torch.where(improved, losses, best_loss))


def track_global_best(gbest_params: PyTree, gbest_loss: torch.Tensor,
                      params: PyTree, loss: torch.Tensor
                      ) -> tuple[PyTree, torch.Tensor]:
    """Eq. 10: keep the best global model seen so far."""
    improved = loss < gbest_loss
    return (tree_map(lambda n, o: torch.where(improved, n, o), params,
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
    total = tree_map(lambda x: torch.zeros(x.shape, dtype=f32,
                                           device=x.device), params)
    for i in range(k):
        mb = tree_map(lambda x: x.reshape((k, x.shape[0] // k)
                                          + tuple(x.shape[1:]))[i], batch)
        total = tree_map(lambda s, g: s + g.to(f32), total,
                         grad_fn(params, mb))
    return tree_map(lambda g, p: (g / k).to(p.dtype), total, params)


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

    def select(self, losses, eta, prev_theta_mean):
        with stage_span("ScoreSelect"):
            return self.score_select_fn(self.algorithm, losses, eta,
                                        self.tau, prev_theta_mean)

    def wire(self, *, delta, theta, mask, global_params, residual,
             ps_residual, draws, phy=None, buffer=None,
             round_idx=None) -> WireOutcome:
        return wire_round(self.comm, delta=delta, theta=theta, mask=mask,
                          global_params=global_params, residual=residual,
                          ps_residual=ps_residual, draws=draws,
                          num_workers=self.num_workers, phy=phy,
                          buffer=buffer, round_idx=round_idx,
                          uplink_fn=self.uplink_fn,
                          aggregate_fn=self.aggregate_fn,
                          downlink_fn=self.downlink_fn)

    def telemetry(self, *, losses, theta, mask, global_loss,
                  outcome: WireOutcome) -> RoundTelemetry:
        rec = outcome.record
        return RoundTelemetry(
            losses=losses, theta=theta, mask=mask, global_loss=global_loss,
            selected_count=mask.sum(),
            uploaded_params=selection.uploaded_parameter_count(
                mask, self.n_params),
            bytes_up=rec.bytes_up, bytes_down=rec.bytes_down,
            delivered=rec.delivered,
            compression_ratio=rec.compression_ratio,
            airtime_s=rec.airtime_s, energy_j=rec.energy_j,
            mean_snr_db=rec.mean_snr_db)


def count_params(params: PyTree) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))
