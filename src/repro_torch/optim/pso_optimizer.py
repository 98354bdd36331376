"""The paper's Eq.-8 PSO-hybrid update packaged as an `Optimizer`.

This exposes M-DSL's local update through the same (init, update)
interface as sgd/adamw. The swarm-level state (local best, global best)
is carried in the optimizer state:

    v' = c0 v + c1 (w_l - w) + c2 (w_g - w) - lr * g
    update = v'

The step's coefficients (c0 ~ U(0,1), c1, c2 ~ N(0,1)) are an input:
`update(..., coeffs=PsoCoefficients(c0, c1, c2))` takes them from the
caller (a parity test passes the JAX package's draws), and without them
they are drawn from the optimizer's torch.Generator (seeded by `seed`,
one draw a step). The JAX package folds the step into a PRNG key kept
in its state instead; the port's state has no key.

The local/global best refresh (Eqs. 9-10) is event-driven on losses, so
it is a separate `observe(state, params, loss, global_params,
global_loss)` transition rather than part of `update`.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union

import torch

from repro_torch.core import pso
from repro_torch.core.pso import PsoCoefficients
from repro_torch.optim.schedules import Schedule
from repro_torch.optim.sgd import Optimizer, _as_schedule
from repro_torch.pytree import tree_leaves, tree_map

PyTree = Any
_F32 = torch.float32


class PsoOptState(NamedTuple):
    velocity: PyTree
    best_params: PyTree          # w^l (Eq. 9)
    best_loss: torch.Tensor
    gbest_params: PyTree         # w^g-bar (Eq. 10)
    gbest_loss: torch.Tensor


def pso_hybrid(lr: Union[float, Schedule], velocity_clip: float = 0.0,
               seed: int = 0) -> Optimizer:
    sched = _as_schedule(lr)
    gen = torch.Generator().manual_seed(seed)

    def init(params):
        dev = tree_leaves(params)[0].device
        inf = torch.tensor(float("inf"), dtype=_F32, device=dev)
        return PsoOptState(
            velocity=tree_map(torch.zeros_like, params),
            best_params=params, best_loss=inf,
            gbest_params=params, gbest_loss=inf)

    def update(grads, state, params, step,
               coeffs: Optional[PsoCoefficients] = None):
        if coeffs is None:
            draw = pso.coefficients(pso.sample_coefficients(gen, 1, "cpu"))
            coeffs = PsoCoefficients(*(c[0] for c in draw))
        lr_t = sched(step)

        def leaf(w, v, wl, wg, g):
            c0, c1, c2 = (torch.as_tensor(c, dtype=_F32, device=w.device)
                          for c in coeffs)
            v_new = (c0 * v.to(_F32) + c1 * (wl - w).to(_F32)
                     + c2 * (wg - w).to(_F32) - lr_t * g.to(_F32))
            if velocity_clip > 0.0:
                v_new = v_new.clamp(-velocity_clip, velocity_clip)
            return v_new.to(w.dtype)

        v_next = tree_map(leaf, params, state.velocity, state.best_params,
                          state.gbest_params, grads)
        return v_next, state._replace(velocity=v_next)

    return Optimizer(init=init, update=update)


def observe(state: PsoOptState, params: PyTree, loss, global_params: PyTree,
            global_loss) -> PsoOptState:
    """Eqs. 9-10 best refresh after a round's evaluation."""
    def f32(x):
        return torch.as_tensor(x, dtype=_F32, device=state.best_loss.device)

    loss, global_loss = f32(loss), f32(global_loss)

    def sel(c, n, o):
        return tree_map(lambda a, b: torch.where(c, a, b), n, o)

    li = loss < state.best_loss
    gi = global_loss < state.gbest_loss
    return state._replace(
        best_params=sel(li, params, state.best_params),
        best_loss=torch.where(li, loss, state.best_loss),
        gbest_params=sel(gi, global_params, state.gbest_params),
        gbest_loss=torch.where(gi, global_loss, state.gbest_loss))
