"""Multi-worker selection (paper §III-C, Eqs. 4-7).

Eq. 5 scores theta_i = tau * F_i + (1 - tau) * eta_i; Eq. 6 selects
every worker with theta_i <= mean_j theta_{j,t-1} (the previous round's
population mean), falling back to the single best worker when nobody
qualifies; Eq. 7 moves the global model by the masked mean delta.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.pytree import tree_map

PyTree = Any


class SelectionState(NamedTuple):
    """The adaptive threshold carried between rounds."""
    prev_theta_mean: torch.Tensor  # +inf on round 0 (everyone selected)


def init_selection_state(device=None) -> SelectionState:
    return SelectionState(prev_theta_mean=torch.tensor(
        float("inf"), dtype=torch.float32, device=device))


def tradeoff_scores(losses: torch.Tensor, eta: torch.Tensor,
                    tau: float = 0.9) -> torch.Tensor:
    """Eq. 5."""
    return tau * losses + (1.0 - tau) * eta


def one_hot_argmin(theta: torch.Tensor) -> torch.Tensor:
    """(C,) f32 indicator of the best (lowest, first on ties) score."""
    out = torch.zeros_like(theta, dtype=torch.float32)
    out[torch.argmin(theta)] = 1.0
    return out


def select_workers(theta: torch.Tensor, sel_state: SelectionState
                   ) -> tuple[torch.Tensor, SelectionState]:
    """Eq. 6 with the >= 1 fallback. Returns (mask (C,) f32, next
    state)."""
    mask = (theta <= sel_state.prev_theta_mean).to(torch.float32)
    mask = torch.where(mask.sum() > 0, mask, one_hot_argmin(theta))
    return mask, SelectionState(prev_theta_mean=theta.mean())


def aggregate_global(global_params: dict, worker_params: dict,
                     prev_worker_params: dict, mask: torch.Tensor) -> dict:
    """Eq. 7: masked mean of per-worker deltas applied to the global
    model (leaves of worker_params carry a leading C)."""
    denom = torch.clamp(mask.sum(), min=1.0)

    def leaf(g, w, w_prev):
        delta = w - w_prev
        m = mask.reshape((-1,) + (1,) * (delta.ndim - 1))
        return (g + (m * delta).sum(dim=0) / denom).to(g.dtype)

    return tree_map(leaf, global_params, worker_params, prev_worker_params)


def uploaded_parameter_count(mask: torch.Tensor,
                             n_params: int) -> torch.Tensor:
    """Comm cost of the round: n * sum_i s_i (paper §IV-C)."""
    return mask.sum() * n_params
