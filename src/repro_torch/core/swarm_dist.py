"""M-DSL as the mesh engine's train step: W spatial workers, each a full
transformer replica, over one stacked swarm state (the JAX package's
`core/swarm_dist.py`).

One `train_step` is one communication round, built on `core/rounds.py`'s
stage pipeline: this module supplies only the LocalUpdate stage (local
SGD steps, then the Eq.-8 PSO displacement); ScoreSelect, the Eq.-7
wire (compression, channel, robust aggregation, compressed downlink)
and the byte accounting are the shared stages.

How the port differs from the reference:

- A Python loop over the W workers takes the place of `jax.vmap`: each
  worker's gradient is `torch.autograd.grad` of its own loss (the
  reference's W == 1 branch is the per-worker body), so one worker's
  gradients and activations live at a time.
- Eq. 8 runs over the stacked (W, ...) state through the fused
  `kernels.pso_update` kernel, one launch per leaf for all workers,
  where the reference evaluates the same arithmetic inline per leaf.
- Every random draw of a round is an explicit input: the batches, the
  eval batch and a `core/mdsl.RoundDraws` (the (W, 3) PSO coefficients,
  the byzantine normals and the wire's seeds, keep, fade, noise and
  crash rows; its `perms` are unused and left empty). The port's runs
  draw them from a torch.Generator (`sample_draws`); parity tests carry
  the reference's across through numpy.
- The straggler engine's buffer is f32 whatever the model's dtype and
  is aggregated leaf by leaf (`comm.straggler.aggregate_and_drain`), as
  the reference does.
- One device: the reference's worker-axis sharding is not ported, and
  `round_idx` is a host int.

`fedavg_train_step` is the same pipeline with the all-ones selection
stage and plain-SGD local deltas from the global model.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.comm import channel as comm_channel
from repro_torch.comm import compress as comm_compress
from repro_torch.comm import phy as comm_phy
from repro_torch.comm import straggler as comm_straggler
from repro_torch.comm.budget import CommConfig
from repro_torch.core import pso, rounds
from repro_torch.core.mdsl import MdslConfig, RoundDraws, sample_round_draws
from repro_torch.core.pso import PsoHyperParams
from repro_torch.core.rounds import RoundTelemetry
from repro_torch.kernels.pso_update.ops import pso_update
from repro_torch.pytree import (tree_flatten, tree_leaves, tree_map,
                                tree_unflatten)

PyTree = Any
LossFn = Callable[[PyTree, dict], torch.Tensor]


class DistSwarmConfig(NamedTuple):
    num_spatial: int                # W
    local_steps: int = 1
    tau: float = 0.9
    hp: PsoHyperParams = PsoHyperParams(learning_rate=3e-3,
                                        velocity_clip=1.0)
    # grad-accumulation chunks per local step: caps activation memory at
    # batch / microbatches
    microbatches: int = 1
    comm: CommConfig = CommConfig()  # wire: compression/channel/aggregation


class DistSwarmState(NamedTuple):
    """All worker leaves stacked over W; global leaves unstacked."""
    params: PyTree                  # (W, ...) worker models
    velocity: PyTree                # (W, ...)
    best_params: PyTree             # (W, ...) w^l (Eq. 9)
    best_loss: torch.Tensor         # (W,)
    global_params: PyTree           # w_t
    gbest_params: PyTree            # w^g-bar (Eq. 10)
    gbest_loss: torch.Tensor        # ()
    prev_theta_mean: torch.Tensor   # () Eq. 6 threshold
    eta: torch.Tensor               # (W,) non-iid degrees
    round_idx: int                  # t (host int)
    residual: PyTree                # (W, ...) uplink error-feedback state
    ps_residual: PyTree             # PS-side downlink error-feedback state
    phy: comm_phy.PhyState          # (W,) per-worker channel state
    buffer: Any = None              # comm.straggler.StragglerBuffer (f32;
    #                                 None while no deadline is set)


def init_state(global_params: PyTree, cfg: DistSwarmConfig,
               eta: Optional[torch.Tensor] = None) -> DistSwarmState:
    W = cfg.num_spatial
    dev = tree_leaves(global_params)[0].device
    stacked = tree_map(lambda x: x.expand((W,) + tuple(x.shape)).clone(),
                       global_params)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    return DistSwarmState(
        params=stacked,
        velocity=tree_map(torch.zeros_like, stacked),
        best_params=stacked,
        best_loss=torch.full((W,), float("inf"), dtype=torch.float32,
                             device=dev),
        global_params=global_params,
        gbest_params=global_params,
        gbest_loss=inf,
        prev_theta_mean=inf.clone(),
        eta=(torch.zeros((W,), dtype=torch.float32, device=dev)
             if eta is None else eta),
        round_idx=0,
        residual=comm_compress.init_residual(stacked),
        ps_residual=rounds.init_ps_residual(global_params),
        phy=comm_phy.init_state(cfg.comm, W, dev),
        buffer=comm_straggler.init_buffer(cfg.comm, stacked),
    )


def sample_draws(gen: torch.Generator, cfg: DistSwarmConfig,
                 params: PyTree, device, round_idx: int) -> RoundDraws:
    """One round's draws from the port's own generator: the coefficients
    and the wire's as `core/mdsl.sample_round_draws` makes them (the
    crash rows of round `round_idx` included), with no epoch
    permutations (local_epochs 0)."""
    return sample_round_draws(gen, MdslConfig(local_epochs=0, comm=cfg.comm),
                              params, cfg.num_spatial, 0, device,
                              round_idx=round_idx)


def _pipeline(cfg: DistSwarmConfig, algorithm: str,
              params: PyTree) -> rounds.RoundPipeline:
    return rounds.RoundPipeline(algorithm=algorithm, comm=cfg.comm,
                                num_workers=cfg.num_spatial, tau=cfg.tau,
                                n_params=rounds.count_params(params))


def _grad_fn(loss_fn: LossFn) -> Callable:
    """(params, batch) -> grads of loss_fn, one worker's tree."""
    def grad_fn(params: PyTree, batch: dict) -> PyTree:
        leaves, treedef = tree_flatten(params)
        xs = [x.detach().requires_grad_() for x in leaves]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(treedef, xs), batch)
            grads = torch.autograd.grad(loss, xs)
        return tree_unflatten(treedef, list(grads))
    return grad_fn


def _worker(tree: PyTree, w: int) -> PyTree:
    return tree_map(lambda x: x[w], tree)


def _local_deltas(grad_fn: Callable, cfg: DistSwarmConfig,
                  start: Callable[[int], PyTree], batch: dict,
                  lr: float, like: PyTree) -> PyTree:
    """(W, ...) stacked d_w = SGD^local_steps(w0_w) - w0_w, one worker at
    a time; start(w) is worker w's w0, `like` one worker's tree."""
    W = cfg.num_spatial
    deltas = tree_map(lambda x: torch.empty((W,) + tuple(x.shape),
                                            dtype=x.dtype, device=x.device),
                      like)
    for w in range(W):
        w0 = start(w)
        p, b = w0, _worker(batch, w)
        for _ in range(cfg.local_steps):
            g = rounds.accumulated_grad(grad_fn, p, b, cfg.microbatches)
            p = pso.sgd_step(p, g, lr)
            del g
        tree_map(lambda out, t, s: torch.sub(t, s, out=out[w]), deltas, p,
                 w0)
        del p
    return deltas


def _eval(loss_fn: LossFn, params: PyTree, eval_batch: dict,
          stacked: bool) -> torch.Tensor:
    with torch.no_grad():
        if not stacked:
            return loss_fn(params, eval_batch)
        W = tree_leaves(params)[0].shape[0]
        return torch.stack([loss_fn(_worker(params, w), eval_batch)
                            for w in range(W)])


def _eq8_coefs(coeffs: torch.Tensor, clip: float) -> torch.Tensor:
    """(W, 3) PSO draws -> the kernel's (W, 4) f32 rows (c0, c1, c2,
    clip)."""
    c = coeffs.to(torch.float32)
    return torch.cat([c, torch.full_like(c[:, :1], float(clip))],
                     dim=1).contiguous()


def build_train_step(loss_fn: LossFn, cfg: DistSwarmConfig
                     ) -> Callable[..., tuple[DistSwarmState,
                                              RoundTelemetry]]:
    """loss_fn(params, batch) -> scalar. Returns
    train_step(state, batch, eval_batch, draws) where every leaf of
    `batch` has a leading worker dim W and `draws` is the round's
    RoundDraws."""
    grad_fn = _grad_fn(loss_fn)

    def train_step(state: DistSwarmState, batch: dict, eval_batch: dict,
                   draws: RoundDraws
                   ) -> tuple[DistSwarmState, RoundTelemetry]:
        pipe = _pipeline(cfg, "mdsl", state.global_params)
        lr = pso.decayed_lr(cfg.hp, state.round_idx)
        with rounds.stage_span("LocalUpdate"):
            # local SGD steps, then Eq. 8 over the stacked state: one
            # fused kernel launch per leaf for all W workers
            deltas = _local_deltas(
                grad_fn, cfg, lambda w: _worker(state.params, w), batch, lr,
                state.global_params)
            coefs = _eq8_coefs(draws.coeffs, cfg.hp.velocity_clip)
            leaves, treedef = tree_flatten(state.params)
            updated = [pso_update(coefs, *xs) for xs in zip(
                leaves, *(tree_leaves(t) for t in (
                    state.velocity, state.best_params, state.gbest_params,
                    deltas)))]
            del deltas
            new_params = tree_unflatten(treedef, [u[0] for u in updated])
            new_vel = tree_unflatten(treedef, [u[1] for u in updated])
            del updated
            # Byzantine workers' local updates are adversarial: the
            # corruption lands in their params so Eq. 6 can reject them
            new_params = comm_channel.corrupt_local_updates(
                cfg.comm, state.params, new_params, draws.byz_noise)
            losses = _eval(loss_fn, new_params, eval_batch, stacked=True)

        # --- ScoreSelect (Eqs. 5-6) ---
        theta, mask, theta_mean = pipe.select(losses, state.eta,
                                              state.prev_theta_mean)

        # --- Uplink -> Aggregate -> Downlink (Eq. 7 through the wire) ---
        delta = tree_map(lambda a, b: a - b, new_params, state.params)
        out = pipe.wire(delta=delta, theta=theta, mask=mask,
                        global_params=state.global_params,
                        residual=state.residual,
                        ps_residual=state.ps_residual, draws=draws,
                        phy=state.phy, buffer=state.buffer)
        del delta
        global_loss = _eval(loss_fn, out.global_params, eval_batch,
                            stacked=False)

        # --- BestTracking (Eqs. 9-10) ---
        with rounds.stage_span("BestTracking"):
            best_params, best_loss = rounds.track_local_best(
                state.best_params, state.best_loss, new_params, losses)
            gbest_params, gbest_loss = rounds.track_global_best(
                state.gbest_params, state.gbest_loss, out.global_params,
                global_loss)

        next_state = DistSwarmState(
            params=new_params, velocity=new_vel, best_params=best_params,
            best_loss=best_loss, global_params=out.global_params,
            gbest_params=gbest_params, gbest_loss=gbest_loss,
            prev_theta_mean=theta_mean, eta=state.eta,
            round_idx=state.round_idx + 1, residual=out.residual,
            ps_residual=out.ps_residual, phy=out.phy, buffer=out.buffer)
        return next_state, pipe.telemetry(losses=losses, theta=theta,
                                          mask=mask,
                                          global_loss=global_loss,
                                          outcome=out)

    return train_step


def fedavg_train_step(loss_fn: LossFn, cfg: DistSwarmConfig):
    """Baseline: plain FedAvg round (all workers, SGD only) — the same
    pipeline with the all-ones selection stage."""
    grad_fn = _grad_fn(loss_fn)
    W = cfg.num_spatial

    def train_step(state: DistSwarmState, batch: dict, eval_batch: dict,
                   draws: RoundDraws
                   ) -> tuple[DistSwarmState, RoundTelemetry]:
        pipe = _pipeline(cfg, "fedavg", state.global_params)
        lr = pso.decayed_lr(cfg.hp, state.round_idx)
        with rounds.stage_span("LocalUpdate"):
            deltas = _local_deltas(grad_fn, cfg,
                                   lambda w: state.global_params, batch, lr,
                                   state.global_params)
            # FedAvg rides the same wire: byzantine deltas, compression
            # with error feedback, channel — but every worker uploads
            zeros = tree_map(torch.zeros_like, deltas)
            deltas = comm_channel.corrupt_local_updates(cfg.comm, zeros,
                                                        deltas,
                                                        draws.byz_noise)
            del zeros
            # real per-worker scores: F_i at w_t + delta_i on the eval
            # batch
            losses = torch.stack([
                _eval(loss_fn, tree_map(lambda g, d: g + d[w],
                                        state.global_params, deltas),
                      eval_batch, stacked=False)
                for w in range(W)])
        theta, mask, _ = pipe.select(losses, state.eta,
                                     state.prev_theta_mean)
        out = pipe.wire(delta=deltas, theta=theta, mask=mask,
                        global_params=state.global_params,
                        residual=state.residual,
                        ps_residual=state.ps_residual, draws=draws,
                        phy=state.phy, buffer=state.buffer)
        del deltas
        global_loss = _eval(loss_fn, out.global_params, eval_batch,
                            stacked=False)
        next_state = state._replace(global_params=out.global_params,
                                    round_idx=state.round_idx + 1,
                                    residual=out.residual,
                                    ps_residual=out.ps_residual,
                                    phy=out.phy, buffer=out.buffer)
        return next_state, pipe.telemetry(losses=losses, theta=theta,
                                          mask=mask,
                                          global_loss=global_loss,
                                          outcome=out)

    return train_step
