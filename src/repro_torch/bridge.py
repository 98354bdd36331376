"""Carry weights and engine state across from numpy.

The port shares the JAX package's layouts (nested param dicts, HWIO conv
weights, stacked-worker leaves), so a reference state converted with
`jax.tree.map(np.asarray, state)` maps onto the port's NamedTuples field
by field. Nothing here imports JAX: the reference side hands over numpy.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.comm.phy import PhyState
from repro_torch.core.mdsl import SwarmTrainState
from repro_torch.core.pso import GlobalBest, WorkerState
from repro_torch.core.selection import SelectionState
from repro_torch.pytree import tree_map

PyTree = Any


def tree_from_numpy(tree: PyTree, device="cpu") -> PyTree:
    """Nested dicts/tuples of arrays -> the same of tensors on `device`
    (dtypes kept)."""
    return tree_map(lambda a: torch.as_tensor(np.array(a)).to(device),
                    tree)


def tree_to_numpy(tree: PyTree) -> PyTree:
    """Nested dicts/tuples of tensors -> the same of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if torch.is_tensor(t) else np.asarray(t), tree)


def train_state_from_numpy(np_state: Any, device="cpu") -> SwarmTrainState:
    """A reference SwarmTrainState with numpy leaves -> the port's."""
    if getattr(np_state, "buffer", None) is not None:
        raise NotImplementedError("the straggler buffer is not ported yet")

    def t(a):
        return tree_from_numpy(a, device)

    w, g, p = np_state.workers, np_state.gbest, np_state.phy
    return SwarmTrainState(
        workers=WorkerState(params=t(w.params), velocity=t(w.velocity),
                            best_params=t(w.best_params),
                            best_loss=t(w.best_loss),
                            prev_loss=t(w.prev_loss)),
        global_params=t(np_state.global_params),
        gbest=GlobalBest(params=t(g.params), loss=t(g.loss),
                         prev_loss=t(g.prev_loss)),
        sel=SelectionState(prev_theta_mean=t(np_state.sel.prev_theta_mean)),
        round_idx=int(np_state.round_idx),
        eta=t(np_state.eta),
        residual=t(np_state.residual),
        ps_residual=t(np_state.ps_residual),
        phy=PhyState(*(t(getattr(p, f)) for f in PhyState._fields)),
        buffer=None)
