"""PSO-hybrid local update of M-DSL (paper §III-B/C, Eqs. 8-10), over
stacked workers (every leaf carries a leading worker dim C).

Eq. 8, round-level form (see repro.core.mdsl's granularity note):

    v' = c0 * v + c1 * (w^l - w) + c2 * (w^g - w) + d
    w' = w + v'

with d the accumulated SGD progress of the round and c0 ~ U(0,1),
c1, c2 ~ N(0,1) drawn per worker and round (paper §V-A). Eq. 9 keeps
each worker's best-F params, Eq. 10 the best global model.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.pso_update.ops import pso_update
from repro_torch.pytree import (tree_flatten, tree_leaves, tree_map,
                                tree_unflatten)

PyTree = Any


class PsoCoefficients(NamedTuple):
    c0: torch.Tensor  # (C,) inertia,   U(0,1)
    c1: torch.Tensor  # (C,) cognitive, N(0,1)
    c2: torch.Tensor  # (C,) social,    N(0,1)


class PsoHyperParams(NamedTuple):
    learning_rate: float = 0.01
    lr_decay: float = 0.5          # attenuation gamma (paper §V-A)
    lr_decay_every: int = 10       # rounds between decays
    velocity_clip: float = 0.0     # 0 = faithful paper (no clip); >0 clips |v|


class WorkerState(NamedTuple):
    """Stacked per-worker swarm state."""
    params: PyTree
    velocity: PyTree
    best_params: PyTree     # w_i^l (Eq. 9)
    best_loss: torch.Tensor  # (C,) F at w_i^l
    prev_loss: torch.Tensor  # (C,) F_{i,t-1}


class GlobalBest(NamedTuple):
    """Shared global-best view (Eq. 10)."""
    params: PyTree
    loss: torch.Tensor
    prev_loss: torch.Tensor


def sample_coefficients(gen: torch.Generator, num_workers: int,
                        device) -> torch.Tensor:
    """(C, 3) per-worker (c0, c1, c2): c0 ~ U(0,1), c1, c2 ~ N(0,1)."""
    c0 = torch.rand(num_workers, generator=gen, device=device)
    c12 = torch.randn(num_workers, 2, generator=gen, device=device)
    return torch.cat([c0[:, None], c12], dim=1)


def coefficients(draw: torch.Tensor) -> PsoCoefficients:
    """(C, 3) draw -> PsoCoefficients of (C,) vectors."""
    return PsoCoefficients(c0=draw[:, 0], c1=draw[:, 1], c2=draw[:, 2])


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def init_worker_state(stacked_params: PyTree) -> WorkerState:
    first = tree_leaves(stacked_params)[0]
    C, dev = first.shape[0], first.device
    inf = torch.full((C,), float("inf"), dtype=torch.float32, device=dev)
    return WorkerState(params=stacked_params,
                       velocity=tree_map(torch.zeros_like, stacked_params),
                       best_params=stacked_params, best_loss=inf,
                       prev_loss=inf.clone())


def init_global_best(params: PyTree) -> GlobalBest:
    dev = tree_leaves(params)[0].device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    return GlobalBest(params=params, loss=inf, prev_loss=inf.clone())


def update_local_best(state: WorkerState,
                      losses: torch.Tensor) -> WorkerState:
    """Eq. 9 per worker: w_i^l <- argmin over {w^l, w_i,t} of F."""
    improved = losses < state.best_loss
    best = tree_map(lambda n, o: torch.where(_bcast(improved, n), n, o),
                    state.params, state.best_params)
    return state._replace(
        best_params=best,
        best_loss=torch.where(improved, losses, state.best_loss),
        prev_loss=losses)


def update_global_best(gbest: GlobalBest, params: PyTree,
                       loss: torch.Tensor) -> GlobalBest:
    """Eq. 10: w^g <- argmin over {w^g, w_t} of F."""
    improved = loss < gbest.loss
    return GlobalBest(
        params=tree_map(lambda n, o: torch.where(improved, n, o), params,
                        gbest.params),
        loss=torch.where(improved, loss, gbest.loss), prev_loss=loss)


def velocity_update(w, v, wl, wg, d, coeffs: PsoCoefficients,
                    clip: float) -> torch.Tensor:
    """Eq. 8's new velocity for one stacked leaf (coefficients per
    worker), clipped to +-clip when clip > 0."""
    c0, c1, c2 = (_bcast(c, w) for c in coeffs)
    v_new = c0 * v + c1 * (wl - w) + c2 * (wg - w) + d
    if clip > 0.0:
        v_new = v_new.clamp(-clip, clip)
    return v_new


def pso_step(state: WorkerState, gbest_params: PyTree, grads: PyTree,
             coeffs: PsoCoefficients, lr: float,
             hp: PsoHyperParams = PsoHyperParams()) -> WorkerState:
    """One Eq.-8 update of every worker, with d = -lr * grad:

        v' = clip(c0 v + c1 (w^l - w) + c2 (w^g - w) - lr g),  w' = w + v'

    through the fused `pso_update` kernel, one launch a leaf for all C
    workers (coefficient rows (c0, c1, c2, clip), w^g broadcast); a CPU
    tensor takes the kernel's plain version."""
    clip = torch.full_like(coeffs.c0, max(hp.velocity_clip, 0.0))
    rows = torch.stack([coeffs.c0, coeffs.c1, coeffs.c2, clip],
                       dim=1).to(torch.float32).contiguous()

    leaves, treedef = tree_flatten(state.params)
    out = [pso_update(rows, w.contiguous(), v.contiguous(), wl.contiguous(),
                      wg.contiguous(), (-lr * g).to(w.dtype).contiguous())
           for w, v, wl, wg, g in zip(leaves, *(tree_leaves(t) for t in (
               state.velocity, state.best_params, gbest_params, grads)))]
    return state._replace(params=tree_unflatten(treedef, [o[0] for o in out]),
                          velocity=tree_unflatten(treedef,
                                                  [o[1] for o in out]))


def sgd_step(params: PyTree, grads: PyTree, lr) -> PyTree:
    """Plain SGD step, dtype-preserving: formed in f32 and rounded once to
    each leaf's dtype, as the reference's f32 learning rate promotes a
    bf16 leaf (a no-op cast for f32 leaves)."""
    f32 = torch.float32
    return tree_map(lambda w, g: (w.to(f32) - lr * g.to(f32)).to(w.dtype),
                    params, grads)


def decayed_lr(hp: PsoHyperParams, round_idx: int) -> float:
    """alpha_init * gamma^(t // k) in f32 (paper §V-A)."""
    exponent = np.float32(round_idx // hp.lr_decay_every)
    return float(np.float32(hp.learning_rate)
                 * np.float32(np.float32(hp.lr_decay) ** exponent))
