"""M-DSL communication round and baselines (paper Algorithm 1 + §V-B),
over stacked workers.

  fedavg    SGD local epochs, all workers aggregated
  dsl       PSO-hybrid local update, single best worker
  multi_dsl PSO-hybrid, Eq.-6 multi-worker selection with tau = 1
  mdsl      PSO-hybrid, selection on theta = tau*F + (1-tau)*eta

LocalUpdate runs E epochs of minibatch SGD for all C workers at once
(`torch.func.vmap` of `torch.func.grad` over the stacked params) and
adds the Eq.-8 PSO terms once per round; with `pso_every_step` it
applies Eq. 8 after every minibatch step instead (`pso.pso_step`: the
fused `pso_update` kernel, one launch a leaf a step), as the reference's
mode of the same name does. ScoreSelect, the wire and the accounting are
`core/rounds.py`'s stages. F_{i,t} for bests and
selection is evaluated on the shared synthetic dataset D_g.

Every random draw of a round is an explicit input, collected in
`RoundDraws`: the port's runs fill it from a torch.Generator
(`sample_round_draws`); parity tests fill it from the JAX key chain.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.comm import channel as comm_channel
from repro_torch.comm import compress as comm_compress
from repro_torch.comm import phy as comm_phy
from repro_torch.comm import straggler as comm_straggler
from repro_torch.comm.budget import CommConfig
from repro_torch.core import pso, rounds, selection
from repro_torch.core.pso import GlobalBest, PsoHyperParams, WorkerState
from repro_torch.core.rounds import RoundTelemetry
from repro_torch.core.selection import SelectionState
from repro_torch.pytree import tree_leaves, tree_map

PyTree = Any
LossFn = Callable[[PyTree, torch.Tensor, torch.Tensor], torch.Tensor]

RoundMetrics = RoundTelemetry


class MdslConfig(NamedTuple):
    algorithm: str = "mdsl"          # fedavg | dsl | multi_dsl | mdsl
    tau: float = 0.9                 # Eq. 5 regularizer
    local_epochs: int = 4
    batch_size: int = 64
    hp: PsoHyperParams = PsoHyperParams()
    pso_every_step: bool = False     # Eq. 8 after every minibatch step
    comm: CommConfig = CommConfig()


def per_step_pso(cfg: MdslConfig) -> bool:
    """Whether LocalUpdate applies Eq. 8 every step (fedavg never does)."""
    return cfg.pso_every_step and cfg.algorithm != "fedavg"


class SwarmTrainState(NamedTuple):
    """Full state; worker leaves carry a leading C dim."""
    workers: WorkerState
    global_params: PyTree            # w_t
    gbest: GlobalBest                # Eq. 10 view
    sel: SelectionState
    round_idx: int                   # t (host int)
    eta: torch.Tensor                # (C,) non-iid degrees
    residual: PyTree                 # (C, ...) uplink EF state
    ps_residual: PyTree              # PS-side downlink EF state
    phy: comm_phy.PhyState
    buffer: Any = None               # comm.straggler.StragglerBuffer
    #                                  (None while no deadline is set)


class RoundDraws(NamedTuple):
    """Every random draw one round consumes."""
    coeffs: torch.Tensor             # (C, 3) PSO c0 ~ U(0,1), c1, c2 ~ N(0,1)
    # (C, E, n) int64 epoch permutations; under per-step Eq. 8 (C, 1, n):
    # one permutation a worker, cycled over the E epochs
    perms: torch.Tensor
    up_seeds: torch.Tensor           # (C, L) int32 uplink rounding seeds
    down_seeds: torch.Tensor         # (L,) int32 downlink rounding seeds
    keep: Optional[torch.Tensor] = None    # (C,) erasure draw, 1 = kept
    fade: Optional[torch.Tensor] = None    # (2, C) fading innovations
    noise: Optional[list] = None     # per-leaf AWGN normals
    byz_noise: Optional[list] = None  # per-leaf (C, *leaf) attack normals
    # (R, C) bool fault-schedule crash rows of rounds t .. t - R + 1
    # (comm.straggler.crash_draws); None unless fault_prob > 0
    crash: Optional[torch.Tensor] = None


def sample_round_draws(gen: torch.Generator, cfg: MdslConfig,
                       params: PyTree, num_workers: int, n_local: int,
                       device, round_idx: int) -> RoundDraws:
    """One round's draws from the port's own generator. The fault
    schedule's crash rows of round `round_idx` come from the schedule's
    own keyed stream (`comm.straggler.crash_draws`), never from `gen`,
    so a run with faults draws the same sequence from `gen` as one
    without."""
    C, comm = num_workers, cfg.comm
    leaves = tree_leaves(params)
    L = len(leaves)
    imax = 2**31 - 1

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device)

    link = comm_phy.link_model(comm)
    shapes = comm_channel.noise_shapes(comm, params, C)
    byz = comm.byzantine > 0 and comm.byzantine_mode == "gaussian"
    return RoundDraws(
        coeffs=pso.sample_coefficients(gen, C, device),
        perms=torch.rand((C, 1 if per_step_pso(cfg) else cfg.local_epochs,
                          n_local), generator=gen,
                         device=device).argsort(dim=-1),
        up_seeds=torch.randint(0, imax, (C, L), generator=gen,
                               device=device, dtype=torch.int32),
        down_seeds=torch.randint(0, imax, (L,), generator=gen,
                                 device=device, dtype=torch.int32),
        keep=((torch.rand(C, generator=gen, device=device)
               < 1.0 - link.drop_prob).to(torch.float32)
              if link.drop_prob > 0.0 else None),
        fade=normal((2, C)) if comm.fading != "none" else None,
        noise=[normal(s) for s in shapes] if shapes else None,
        byz_noise=([normal((C,) + tuple(x.shape)) for x in leaves]
                   if byz else None),
        crash=(torch.from_numpy(comm_straggler.crash_draws(
            comm, round_idx, C)).to(device)
            if comm_straggler.fault_mode(comm) else None),
    )


def init_state(params: PyTree, num_workers: int, eta: torch.Tensor,
               comm: CommConfig = CommConfig()) -> SwarmTrainState:
    """All workers start from the common global init `params`."""
    stacked = tree_map(
        lambda x: x.expand((num_workers,) + tuple(x.shape)).clone(), params)
    dev = tree_leaves(params)[0].device
    return SwarmTrainState(
        workers=pso.init_worker_state(stacked),
        global_params=params,
        gbest=pso.init_global_best(params),
        sel=selection.init_selection_state(dev),
        round_idx=0,
        eta=eta,
        residual=comm_compress.init_residual(stacked),
        ps_residual=rounds.init_ps_residual(params),
        phy=comm_phy.init_state(comm, num_workers, dev),
        buffer=comm_straggler.init_buffer(comm, stacked),
    )


def eval_stacked(eval_fn: LossFn, params: PyTree, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """(C,) F of every worker's params on the shared set (x, y)."""
    with torch.no_grad():
        return torch.func.vmap(eval_fn, in_dims=(0, None, None))(params, x, y)


def _local_sgd_epochs(params: PyTree, data_x: torch.Tensor,
                      data_y: torch.Tensor, loss_fn: LossFn, lr: float,
                      cfg: MdslConfig, perms: torch.Tensor) -> PyTree:
    """E epochs of minibatch SGD for all workers; perms (C, E, n)."""
    C, n = data_x.shape[:2]
    bs = min(cfg.batch_size, n)
    steps = n // bs
    grad_fn = torch.func.vmap(torch.func.grad(loss_fn))
    rows = torch.arange(C, device=data_x.device)[:, None]
    for e in range(cfg.local_epochs):
        idx = perms[:, e, :steps * bs]
        xe, ye = data_x[rows, idx], data_y[rows, idx]
        for s in range(steps):
            sl = slice(s * bs, (s + 1) * bs)
            params = pso.sgd_step(params, grad_fn(params, xe[:, sl],
                                                  ye[:, sl]), lr)
    return params


def _pso_every_step(workers: WorkerState, gbest_params: PyTree,
                    data_x: torch.Tensor, data_y: torch.Tensor,
                    loss_fn: LossFn, coeffs: pso.PsoCoefficients, lr: float,
                    cfg: MdslConfig, perm: torch.Tensor) -> WorkerState:
    """Per-step Eq. 8: (n // bs) * E minibatch steps, each the gradients
    of all C workers then one `pso.pso_step`. The minibatches run through
    one permutation a worker (perm (C, n)) repeated end to end, as the
    reference's `jnp.resize` does."""
    C, n = data_x.shape[:2]
    bs = min(cfg.batch_size, n)
    steps = (n // bs) * cfg.local_epochs
    idx = perm.repeat(1, -(-steps * bs // n))[:, :steps * bs]
    grad_fn = torch.func.vmap(torch.func.grad(loss_fn))
    rows = torch.arange(C, device=data_x.device)[:, None]
    for s in range(steps):
        i = idx[:, s * bs:(s + 1) * bs]
        grads = grad_fn(workers.params, data_x[rows, i], data_y[rows, i])
        workers = pso.pso_step(workers, gbest_params, grads, coeffs, lr,
                               cfg.hp)
    return workers


def local_update(workers: WorkerState, gbest_params: PyTree,
                 data_x: torch.Tensor, data_y: torch.Tensor,
                 loss_fn: LossFn, coeffs: pso.PsoCoefficients, lr: float,
                 cfg: MdslConfig, perms: torch.Tensor) -> WorkerState:
    """Round-level Eq. 8: E SGD epochs, then the PSO displacement once
    (fedavg keeps the SGD result); per-step Eq. 8 under
    `cfg.pso_every_step`."""
    if per_step_pso(cfg):
        return _pso_every_step(workers, gbest_params, data_x, data_y,
                               loss_fn, coeffs, lr, cfg, perms[:, 0])
    w0 = workers.params
    trained = _local_sgd_epochs(w0, data_x, data_y, loss_fn, lr, cfg, perms)
    sgd_delta = tree_map(lambda a, b: a - b, trained, w0)
    if cfg.algorithm == "fedavg":
        return workers._replace(params=trained, velocity=sgd_delta)
    clip = cfg.hp.velocity_clip
    v_next = tree_map(
        lambda w, v, wl, wg, d: pso.velocity_update(w, v, wl, wg, d, coeffs,
                                                    clip),
        w0, workers.velocity, workers.best_params, gbest_params, sgd_delta)
    return workers._replace(params=tree_map(torch.add, w0, v_next),
                            velocity=v_next)


def mdsl_round(state: SwarmTrainState, data_x: torch.Tensor,
               data_y: torch.Tensor, eval_x: torch.Tensor,
               eval_y: torch.Tensor, draws: RoundDraws, *, loss_fn: LossFn,
               eval_fn: LossFn, cfg: MdslConfig, n_params: int
               ) -> tuple[SwarmTrainState, RoundTelemetry]:
    """One communication round (Algorithm 1 body). data_x/data_y: the
    stacked local datasets (C, n, ...); eval_x/eval_y: D_g."""
    C = data_x.shape[0]
    pipe = rounds.RoundPipeline(algorithm=cfg.algorithm, comm=cfg.comm,
                                num_workers=C, tau=cfg.tau,
                                n_params=n_params)
    lr = pso.decayed_lr(cfg.hp, state.round_idx)

    # --- LocalUpdate (Algorithm 1 lines 3-4) ---
    with rounds.stage_span("LocalUpdate"):
        pre_losses = eval_stacked(eval_fn, state.workers.params, eval_x,
                                  eval_y)
        workers = pso.update_local_best(state.workers, pre_losses)
        prev_params = workers.params
        workers = local_update(workers, state.gbest.params, data_x, data_y,
                               loss_fn, pso.coefficients(draws.coeffs), lr,
                               cfg, draws.perms)
        workers = workers._replace(params=comm_channel.corrupt_local_updates(
            cfg.comm, prev_params, workers.params, draws.byz_noise))
        eval_losses = eval_stacked(eval_fn, workers.params, eval_x, eval_y)

    # --- ScoreSelect (lines 5-6, Eqs. 4-6) ---
    theta, mask, theta_mean = pipe.select(eval_losses, state.eta,
                                          state.sel.prev_theta_mean)

    # --- Uplink -> Aggregate -> Downlink (lines 7-9, Eq. 7) ---
    delta = tree_map(lambda a, b: a - b, workers.params, prev_params)
    out = pipe.wire(delta=delta, theta=theta, mask=mask,
                    global_params=state.global_params,
                    residual=state.residual, ps_residual=state.ps_residual,
                    draws=draws, phy=state.phy, buffer=state.buffer)

    # --- BestTracking (Eq. 10) ---
    with rounds.stage_span("BestTracking"), torch.no_grad():
        global_loss = eval_fn(out.global_params, eval_x, eval_y)
        gbest = pso.update_global_best(state.gbest, out.global_params,
                                       global_loss)
    next_state = SwarmTrainState(
        workers=workers, global_params=out.global_params, gbest=gbest,
        sel=SelectionState(prev_theta_mean=theta_mean),
        round_idx=state.round_idx + 1, eta=state.eta,
        residual=out.residual, ps_residual=out.ps_residual, phy=out.phy,
        buffer=out.buffer)
    return next_state, pipe.telemetry(losses=eval_losses, theta=theta,
                                      mask=mask, global_loss=global_loss,
                                      outcome=out)


count_params = rounds.count_params
