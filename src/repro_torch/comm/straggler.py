"""Gates of the deadline-driven straggler engine.

Only the switches are ported so far: `active` (a round deadline is set)
and `fault_mode` (deterministic worker churn). The engine itself — late
masks from airtime, the parked-delta buffer and its staleness-discounted
drain, quorum holds and the fault schedule (repro.comm.straggler) — is
still to be ported; a config that needs it raises NotImplementedError.
"""
from __future__ import annotations

from typing import Any

from repro_torch.comm.budget import CommConfig

PyTree = Any


def active(cfg: CommConfig) -> bool:
    """Is the straggler engine on (a round deadline set)?"""
    return cfg.round_deadline_s is not None


def fault_mode(cfg: CommConfig) -> bool:
    """Is deterministic worker churn on?"""
    return cfg.fault_prob > 0.0


def require_off(cfg: CommConfig) -> None:
    """Raise for the configs whose engine is not ported yet."""
    if active(cfg) or fault_mode(cfg):
        raise NotImplementedError(
            "the straggler engine (round_deadline_s / fault_prob) is not "
            "ported to repro_torch yet")


def init_buffer(cfg: CommConfig, stacked_params: PyTree) -> None:
    """The parked-delta state: None while the engine is off."""
    require_off(cfg)
    return None
