"""Carry weights and engine state across from numpy.

The port shares the JAX package's layouts (nested param dicts, HWIO conv
weights, stacked-worker leaves, stacked layer groups), so a reference
state converted with `jax.tree.map(np.asarray, state)` maps onto the
port's NamedTuples field by field, and a reference `Transformer.init`
tree onto the port's transformer params leaf by leaf. Nothing here
imports JAX: the reference side hands over numpy.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.comm.phy import PhyState
from repro_torch.comm.straggler import StragglerBuffer
from repro_torch.core.mdsl import SwarmTrainState
from repro_torch.core.population import PopulationTable
from repro_torch.core.pso import GlobalBest, WorkerState
from repro_torch.core.selection import SelectionState
from repro_torch.models.transformer import Transformer
from repro_torch.pytree import tree_map

PyTree = Any


def tree_from_numpy(tree: PyTree, device="cpu") -> PyTree:
    """Nested dicts/tuples of arrays -> the same of tensors on `device`
    (dtypes kept)."""
    return tree_map(lambda a: array_to_tensor(a).to(device), tree)


def tree_to_numpy(tree: PyTree) -> PyTree:
    """Nested dicts/tuples of tensors -> the same of numpy arrays, bit for
    bit (bf16 leaves as `tensor_to_array` gives them)."""
    return tree_map(lambda t: tensor_to_array(t)
                    if torch.is_tensor(t) else np.asarray(t), tree)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """One tensor -> a numpy array on the host, bit for bit. numpy has no
    bfloat16, so a bf16 tensor becomes its 2-byte words as a `|V2` array:
    what `np.savez` writes for a JAX bf16 leaf, and what
    `array_to_tensor` reads back as bf16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def train_state_from_numpy(np_state: Any, device="cpu") -> SwarmTrainState:
    """A reference SwarmTrainState with numpy leaves -> the port's (its
    straggler buffer, when it has one, included)."""
    def t(a):
        return tree_from_numpy(a, device)

    w, g, p, b = (np_state.workers, np_state.gbest, np_state.phy,
                  getattr(np_state, "buffer", None))
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
        phy=phy_state_from_numpy(p, device),
        buffer=(None if b is None
                else StragglerBuffer(delta=t(b.delta), age=t(b.age))))


def phy_state_from_numpy(np_phy: Any, device="cpu") -> PhyState:
    """A reference PhyState with numpy leaves -> the port's."""
    return PhyState(*(tree_from_numpy(getattr(np_phy, f), device)
                      for f in PhyState._fields))


def population_table_from_numpy(np_table: Any,
                                device="cpu") -> PopulationTable:
    """A reference PopulationTable with numpy leaves -> the port's."""
    return PopulationTable(
        phy=phy_state_from_numpy(np_table.phy, device),
        **{f: tree_from_numpy(getattr(np_table, f), device)
           for f in PopulationTable._fields if f != "phy"})


def array_to_tensor(a) -> torch.Tensor:
    """One numpy array -> a CPU tensor, dtype kept. A bfloat16 array
    crosses bit for bit through its uint16 view, with no import of
    ml_dtypes: ml_dtypes' bfloat16 (what `np.asarray` gives for a JAX
    bf16 array) or 2-byte raw words `|V2` (what `np.load` gives for a
    bf16 leaf `np.savez` wrote, and what `tensor_to_array` gives; no
    other dtype numpy writes is `|V2`)."""
    a = np.array(a)                  # a writable copy
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def transformer_params_from_numpy(cfg, np_params: PyTree, device="cpu"
                                  ) -> PyTree:
    """A reference `Transformer(cfg).init(key)` tree with numpy leaves ->
    the port's params on `device`. Every leaf's path, shape and dtype is
    checked against the port's own init (on the meta device)."""
    want = Transformer(cfg).init(None, "meta")

    def walk(w, got, path):
        if isinstance(w, dict):
            if not isinstance(got, dict) or set(got) != set(w):
                have = sorted(got) if isinstance(got, dict) else type(got)
                raise ValueError(f"{path or '/'}: keys {have}, expected "
                                 f"{sorted(w)}")
            return {k: walk(w[k], got[k], f"{path}/{k}") for k in w}
        t = array_to_tensor(got)
        if tuple(t.shape) != tuple(w.shape) or t.dtype != w.dtype:
            raise ValueError(f"{path}: {t.dtype} {tuple(t.shape)}, expected "
                             f"{w.dtype} {tuple(w.shape)}")
        return t.to(device)

    return walk(want, np_params, "")
