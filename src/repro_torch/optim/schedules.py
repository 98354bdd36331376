"""Learning-rate schedules: functions of the int step returning a 0-d
f32 tensor, as the JAX package's return f32 arrays.

The paper uses an attenuated learning rate alpha_init * gamma^(t // k)
(§V-A: alpha_init=0.01, gamma=0.5) — `step_decay` is that schedule;
the rest are standard production schedules for the mesh trainer.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], torch.Tensor]  # step -> lr


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float) -> Schedule:
    return lambda step: _f32(lr)


def step_decay(init_lr: float, gamma: float = 0.5,
               every: int = 10) -> Schedule:
    """Paper §V-A attenuation: lr = init * gamma^(step // every)."""
    def fn(step):
        return init_lr * (gamma ** _f32(int(step) // every))
    return fn


def cosine_decay(init_lr: float, total_steps: int,
                 final_frac: float = 0.1) -> Schedule:
    def fn(step):
        t = _f32(step / max(total_steps, 1)).clamp(0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return init_lr * (final_frac + (1.0 - final_frac) * cos)
    return fn


def warmup_cosine(init_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    cos = cosine_decay(init_lr, max(total_steps - warmup_steps, 1),
                       final_frac)

    def fn(step):
        if step < warmup_steps:
            return _f32(init_lr * step / max(warmup_steps, 1))
        return cos(step - warmup_steps)
    return fn
