"""Hand-rolled optimizers over parameter trees (nested dicts, tuples
and lists of tensors; `repro_torch.pytree`).

An `Optimizer` is an (init, update) pair in the optax style:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

Updates are *deltas to add* (the sign is already folded in). Every
optimizer state is a tree of the params' structure. The arithmetic
follows the JAX package's promotion: a term with the f32 learning rate
is formed in f32 and each update is rounded once to its param's dtype.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.optim.schedules import Schedule, constant
from repro_torch.pytree import tree_leaves, tree_map

PyTree = Any
OptState = Any
_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[PyTree], OptState]
    update: Callable[..., tuple[PyTree, OptState]]  # (grads, state, params, step)


def _as_schedule(lr: Union[float, Schedule]) -> Schedule:
    return constant(lr) if isinstance(lr, (int, float)) else lr


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(_F32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.to(_F32) * scale).to(x.dtype), tree)


def sgd(lr: Union[float, Schedule],
        weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return ()

    def update(grads, state, params, step):
        lr_t = sched(step)

        def leaf(g, p):
            if weight_decay:
                g = g + weight_decay * p.to(g.dtype)
            return (-lr_t * g.to(_F32)).to(p.dtype)
        return tree_map(leaf, grads, params), state

    return Optimizer(init=init, update=update)


class MomentumState(NamedTuple):
    momentum: PyTree


def momentum_sgd(lr: Union[float, Schedule], beta: float = 0.9,
                 nesterov: bool = False,
                 weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return MomentumState(tree_map(torch.zeros_like, params))

    def update(grads, state, params, step):
        lr_t = sched(step)

        def mom(m, g, p):
            if weight_decay:
                g = g + weight_decay * p.to(g.dtype)
            return (beta * m + g).to(m.dtype)

        m_next = tree_map(mom, state.momentum, grads, params)
        if nesterov:
            upd = tree_map(
                lambda m, g, p: (-lr_t * (beta * m + g).to(_F32)).to(p.dtype),
                m_next, grads, params)
        else:
            upd = tree_map(lambda m, p: (-lr_t * m.to(_F32)).to(p.dtype),
                           m_next, params)
        return upd, MomentumState(m_next)

    return Optimizer(init=init, update=update)


class AdamWState(NamedTuple):
    mu: PyTree
    nu: PyTree


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        def z():
            return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                                  device=p.device), params)
        return AdamWState(mu=z(), nu=z())

    def update(grads, state, params, step):
        lr_t = sched(step)
        t = torch.as_tensor(step + 1.0, dtype=_F32)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def mu_f(m, g):
            return b1 * m + (1 - b1) * g.to(_F32)

        def nu_f(v, g):
            g32 = g.to(_F32)
            return b2 * v + (1 - b2) * g32 * g32

        mu = tree_map(mu_f, state.mu, grads)
        nu = tree_map(nu_f, state.nu, grads)

        def upd(m, v, p):
            step_ = m / c1 / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.to(_F32)
            return (-lr_t * step_).to(p.dtype)

        return tree_map(upd, mu, nu, params), AdamWState(mu, nu)

    return Optimizer(init=init, update=update)
