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
- `round_idx` is a host int.

One round body (`_round`) serves one process and a mesh; a `_Fleet`
says how the stacks are laid out. On a mesh (`_MeshFleet`: the state's
leaves DTensors, placed by `launch/steps`), the worker dim of the
(W, ...) state and batch is sharded over `cfg.worker_axes`, the
analogue of the reference's `spmd_axis_name`:
each rank runs its own workers, one at a time, on `to_local()` views
(indexing a worker-sharded DTensor would gather the whole stack), each
replica a DTensor over the remaining mesh axes (tensor parallelism, FSDP
through `sharding.shard`). What needs every worker goes through
collectives over the worker axes: the losses (and so theta and the
selection), the Eq.-7 aggregate and gbest. The wire runs on the state's
own layout, so that no rank gathers the whole model: the dense and
straggler routes gather the deltas, residuals and parked deltas over
the worker axes only and aggregate on each rank's model shards; on the
packed route the rank packs its workers and `wire_agg` runs on every
rank over the all-gathered uint8 payloads and scales, a leaf at a time.
Either way the aggregate is bitwise the one-rank one.

`fedavg_train_step` is the same pipeline with the all-ones selection
stage and plain-SGD local deltas from the global model.
"""
from __future__ import annotations

import contextlib
import functools
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
from repro_torch.sharding import boundary
from repro_torch.sharding.rules import axis_names, is_dtensor

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
    # mesh axes the worker dim is sharded over on a mesh (() on one
    # device, and in fsdp mode: one spatial worker)
    worker_axes: tuple = ()


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
            with rounds.stage_span("LocalUpdate.train.fwd"):
                loss = loss_fn(tree_unflatten(treedef, xs), batch)
            with rounds.stage_span("LocalUpdate.train.bwd"):
                grads = torch.autograd.grad(loss, xs)
        return tree_unflatten(treedef, list(grads))
    return grad_fn


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
    RoundDraws (the whole fleet's, the same on every rank of a mesh)."""
    grad_fn = _grad_fn(loss_fn)
    return lambda state, batch, eval_batch, draws: _round(
        loss_fn, grad_fn, cfg, "mdsl", state, batch, eval_batch, draws)


def fedavg_train_step(loss_fn: LossFn, cfg: DistSwarmConfig):
    """Baseline: plain FedAvg round (all workers, SGD only) — the same
    pipeline with the all-ones selection stage and plain-SGD deltas from
    the global model."""
    grad_fn = _grad_fn(loss_fn)
    return lambda state, batch, eval_batch, draws: _round(
        loss_fn, grad_fn, cfg, "fedavg", state, batch, eval_batch, draws)


def _round(loss_fn: LossFn, grad_fn: Callable, cfg: DistSwarmConfig,
           algorithm: str, state: DistSwarmState, batch: dict,
           eval_batch: dict, draws: RoundDraws
           ) -> tuple[DistSwarmState, RoundTelemetry]:
    """One round (M-DSL or FedAvg) over the fleet's layout (`_Fleet`: one
    process, or a mesh); the state that comes out is laid out leaf for
    leaf as the one that went in."""
    fleet = _fleet(cfg, state)
    pipe = _pipeline(cfg, algorithm, state.global_params)
    lr = pso.decayed_lr(cfg.hp, state.round_idx)
    with fleet.context():
        def local_deltas(start: Callable[[int], PyTree]) -> PyTree:
            """(W, ...) stacked d_w = SGD^local_steps(w0_w) - w0_w for
            this rank's workers, one at a time; start(i) is worker i's
            w0."""
            deltas = tree_map(torch.empty_like, state.params)
            for i in fleet.workers:
                w0 = start(i)
                p, b = w0, tree_map(lambda x: fleet.view(x, i), batch)
                for _ in range(cfg.local_steps):
                    g = rounds.accumulated_grad(grad_fn, p, b,
                                                cfg.microbatches)
                    p = pso.sgd_step(p, g, lr)
                    del g
                tree_map(lambda out, t, s: fleet.store_sub(out, i, t, s),
                         deltas, p, w0)
                del p
            return deltas

        def worker_losses(params_of: Callable[[int], PyTree]):
            """(W,) F_i on D_g, every worker's on every rank."""
            with torch.no_grad():
                return fleet.all_rows(torch.stack([
                    fleet.full(loss_fn(params_of(i), eval_w))
                    for i in fleet.workers]))

        with rounds.stage_span("LocalUpdate"):
            # the fleet-wide rows the later stages read
            small = {k: tree_map(fleet.full, getattr(state, k))
                     for k in ("best_loss", "gbest_loss", "prev_theta_mean",
                               "eta", "phy")}
            eval_w = tree_map(fleet.replica, eval_batch)
            if algorithm == "mdsl":
                # local SGD steps, then Eq. 8 over the stacked state: one
                # fused kernel launch per leaf for all of a rank's workers
                with rounds.stage_span("LocalUpdate.train"):
                    deltas = local_deltas(lambda i: tree_map(
                        lambda x: fleet.view(x, i), state.params))
                with rounds.stage_span("LocalUpdate.eq8"):
                    coefs = _eq8_coefs(draws.coeffs, cfg.hp.velocity_clip)
                    leaves, treedef = tree_flatten(state.params)
                    updated = [pso_update(coefs, *xs) for xs in zip(
                        leaves, *(tree_leaves(t) for t in (
                            state.velocity, state.best_params,
                            state.gbest_params, deltas)))]
                    del deltas
                    new_params = tree_unflatten(treedef,
                                                [u[0] for u in updated])
                    new_vel = tree_unflatten(treedef, [u[1] for u in updated])
                    del updated
                    # Byzantine workers' local updates are adversarial:
                    # the corruption lands in their params so Eq. 6 can
                    # reject them
                    new_params = comm_channel.corrupt_local_updates(
                        cfg.comm, state.params, new_params, draws.byz_noise)
                with rounds.stage_span("LocalUpdate.score"):
                    losses = worker_losses(lambda i: tree_map(
                        lambda x: fleet.view(x, i), new_params))
                # after the scoring, so that the delta is not held through
                # its forwards
                delta = tree_map(lambda a, b: a - b, new_params,
                                 state.params)
            else:
                g = tree_map(fleet.replica, state.global_params)
                with rounds.stage_span("LocalUpdate.train"):
                    deltas = local_deltas(lambda i: g)
                # FedAvg rides the same wire: byzantine deltas,
                # compression with error feedback, channel — but every
                # worker uploads
                zeros = tree_map(torch.zeros_like, deltas)
                delta = comm_channel.corrupt_local_updates(
                    cfg.comm, zeros, deltas, draws.byz_noise)
                del zeros, deltas
                # real per-worker scores: F_i at w_t + delta_i on D_g
                with rounds.stage_span("LocalUpdate.score"):
                    losses = worker_losses(lambda i: tree_map(
                        lambda a, d: a + fleet.view(d, i), g, delta))

        # --- ScoreSelect (Eqs. 5-6) ---
        sel = pipe.select(losses, small["eta"], small["prev_theta_mean"])

        # --- Uplink -> Aggregate -> Downlink (Eq. 7 through the wire) ---
        out = fleet.wire(pipe, state, small["phy"], delta, sel.theta,
                         sel.mask, draws)
        del delta
        with rounds.stage_span("GlobalLoss"):
            global_loss = fleet.full(_eval(loss_fn, out.global_params,
                                           eval_batch))
        telemetry = pipe.telemetry(losses=losses, sel=sel,
                                   global_loss=global_loss, outcome=out)
        if algorithm == "fedavg":
            return state._replace(
                global_params=out.global_params,
                round_idx=state.round_idx + 1, residual=out.residual,
                ps_residual=out.ps_residual, phy=out.phy,
                buffer=out.buffer), telemetry

        # --- BestTracking (Eqs. 9-10) ---
        with rounds.stage_span("BestTracking"):
            best_params, best_loss = rounds.track_local_best(
                state.best_params, small["best_loss"], new_params, losses,
                where=fleet.where_rows)
            gbest_params, gbest_loss = rounds.track_global_best(
                state.gbest_params, small["gbest_loss"], out.global_params,
                global_loss, where=fleet.where)
            best_loss = fleet.place(best_loss, state.best_loss)
            gbest_loss = fleet.place(gbest_loss, state.gbest_loss)
            theta_mean = fleet.place(sel.theta_mean, state.prev_theta_mean)
    return DistSwarmState(
        params=new_params, velocity=new_vel, best_params=best_params,
        best_loss=best_loss, global_params=out.global_params,
        gbest_params=gbest_params, gbest_loss=gbest_loss,
        prev_theta_mean=theta_mean, eta=state.eta,
        round_idx=state.round_idx + 1, residual=out.residual,
        ps_residual=out.ps_residual, phy=out.phy,
        buffer=out.buffer), telemetry


def _eval(loss_fn: LossFn, params: PyTree, eval_batch: dict):
    with torch.no_grad():
        return loss_fn(params, eval_batch)


# ---------------------------------------------------------------------------
# the fleet's layout: one process, or the worker dim over cfg.worker_axes
# ---------------------------------------------------------------------------

class _Fleet:
    """The (W, ...) stacks whole in one process: this process runs every
    worker, a worker's leaf is an index, and the cross-worker stages see
    the whole stacks as they are."""

    def __init__(self, W: int):
        self.workers = range(W)

    def context(self):
        return contextlib.nullcontext()

    def view(self, x, i: int):
        """Worker i's leaf of a stacked one."""
        return x[i]

    def replica(self, x):
        """A leaf shared by the workers, as one worker computes with it."""
        return x

    def store_sub(self, out, i: int, t, s) -> None:
        """out[i] = t - s."""
        torch.sub(t, s, out=out[i])

    def all_rows(self, local: torch.Tensor) -> torch.Tensor:
        return local

    def full(self, x):
        return x

    def place(self, full: torch.Tensor, like):
        return full

    def where_rows(self, cond: torch.Tensor, new, old):
        """Per worker: new where cond (W,), else old."""
        return rounds.where_rows(cond, new, old)

    def where(self, cond: torch.Tensor, new, old):
        return torch.where(cond, new, old)

    def wire(self, pipe, state, phy, delta, theta, mask, draws):
        return pipe.wire(delta=delta, theta=theta, mask=mask,
                         global_params=state.global_params,
                         residual=state.residual,
                         ps_residual=state.ps_residual, draws=draws,
                         phy=phy, buffer=state.buffer)


def _fleet(cfg: DistSwarmConfig, state: DistSwarmState) -> _Fleet:
    leaf = tree_leaves(state.params)[0]
    if is_dtensor(leaf):
        return _MeshFleet(cfg, leaf.device_mesh)
    return _Fleet(cfg.num_spatial)


class _MeshFleet(_Fleet):
    """The worker dim sharded over the mesh's worker axes (the state's
    leaves DTensors): this rank runs its own workers on `to_local()`
    views, each replica a DTensor over the remaining axes (`sub`); what
    needs every worker is gathered over the worker axes."""

    def __init__(self, cfg: DistSwarmConfig, mesh):
        names = axis_names(mesh)
        self.mesh = mesh
        self.wdims = tuple(names.index(a) for a in cfg.worker_axes)
        off, size = 0, cfg.num_spatial
        for d in self.wdims:
            size //= mesh.size(d)
            off += mesh.get_local_rank(d) * size
        self.rows = slice(off, off + size)
        self.workers = range(size)

    @functools.cached_property
    def sub(self):
        """The mesh over the axes other than the workers': slicing runs
        tensor ops on the mesh's rank table, so it waits for the first
        view, inside LocalUpdate."""
        if not self.wdims:
            return self.mesh
        rest = tuple(n for d, n in enumerate(axis_names(self.mesh))
                     if d not in self.wdims)
        return self.mesh[rest if len(rest) > 1 else rest[0]]

    def context(self):
        # model code mixes plain tensors (positions, masks) into DTensors
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()

    def _sub_placements(self, x, stacked: bool) -> list:
        from torch.distributed.tensor import Shard
        return [Shard(p.dim - 1) if stacked and p.is_shard() else p
                for d, p in enumerate(x.placements) if d not in self.wdims]

    def view(self, x, i: int):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(x.to_local()[i], self.sub,
                                  self._sub_placements(x, True),
                                  run_check=False)

    def replica(self, x):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(x.to_local(), self.sub,
                                  self._sub_placements(x, False),
                                  run_check=False)

    def store_sub(self, out, i: int, t, s) -> None:
        local = (t - s).redistribute(self.sub,
                                     self._sub_placements(out, True))
        out.to_local()[i].copy_(local.to_local())

    def all_rows(self, local: torch.Tensor) -> torch.Tensor:
        """Every worker's rows, from each rank's (W_local, ...) ones."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        pl = [Shard(0) if d in self.wdims else Replicate()
              for d in range(self.mesh.ndim)]
        return DTensor.from_local(local, self.mesh, pl,
                                  run_check=False).full_tensor()

    def full(self, x):
        return x.full_tensor() if is_dtensor(x) else x

    def place(self, full: torch.Tensor, like):
        """The DTensor laid out as `like` whose shards are slices of
        `full` (the same on every rank)."""
        from torch.distributed.tensor import DTensor
        local = full
        for d, p in enumerate(like.placements):
            if p.is_shard():
                local = local.chunk(self.mesh.size(d), dim=p.dim)[
                    self.mesh.get_local_rank(d)].contiguous()
        return DTensor.from_local(local, self.mesh, like.placements,
                                  run_check=False)

    def where_rows(self, cond: torch.Tensor, new, old):
        c = cond[self.rows]
        return self.where(c.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

    def where(self, cond: torch.Tensor, new, old):
        """torch.where on the shards of two DTensors laid out alike."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            torch.where(cond, new.to_local(), old.to_local()),
            old.device_mesh, old.placements, run_check=False)

    def _over_workers(self, x):
        """Every worker's rows of a stacked DTensor on this rank: gathered
        over the worker axes only, its placements over the other axes
        kept."""
        from torch.distributed.tensor import Replicate
        if not is_dtensor(x):
            return x
        return x.redistribute(self.mesh, [
            Replicate() if d in self.wdims else p
            for d, p in enumerate(x.placements)])

    def _as(self, x, like):
        """x laid out as `like`: a DTensor redistributed, a tensor the
        same on every rank placed."""
        if is_dtensor(x):
            return boundary.relayout(x, like.placements)
        return self.place(x, like)

    def wire(self, pipe, state, phy, delta, theta, mask, draws):
        """The wire on the state's own layout; every rank ends with the
        same aggregate and broadcast, the global model and the PS
        residual staying as they are laid out. The dense and straggler
        routes gather each worker's delta, residual and parked delta over
        the worker axes only, and the Eq.-7 aggregate runs elementwise on
        this rank's model shards (bitwise the one-rank aggregate). On the
        packed route the kernel boundary gathers one leaf at a time: its
        rows of this rank's workers for quantize-pack (a block's scale
        spans the leaf), then every worker's payloads for `wire_agg`. A
        dense-route stage that needs a whole leaf (top-k, a quantizing
        compressor or downlink, AWGN's power) gathers that leaf where it
        acts."""
        sent = state
        if not (pipe.uplink_fn is rounds.uplink
                and pipe.aggregate_fn is comm_channel.receive
                and comm_compress.packed_wire_eligible(pipe.comm, delta)):
            gather = lambda t: (None if t is None
                                else tree_map(self._over_workers, t))
            with rounds.stage_span("WireGather"):
                delta = gather(delta)
                sent = state._replace(residual=gather(state.residual),
                                      buffer=gather(state.buffer))
        out = super().wire(pipe, sent, phy, delta, theta, mask, draws)
        with rounds.stage_span("WireRelayout"):
            return out._replace(**{
                k: None if getattr(out, k) is None
                else tree_map(self._as, getattr(out, k), getattr(state, k))
                for k in ("global_params", "ps_residual", "residual", "phy",
                          "buffer")})
