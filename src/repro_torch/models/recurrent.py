"""Recurrent temporal-mixing block of the port: RG-LRU (RecurrentGemma,
arXiv:2402.19427), as the JAX package's `models/recurrent.py`.

    x -> norm -> { branch_y = gelu(W_y x) ; branch_x = conv1d_4(W_x x) ->
      RG-LRU } -> W_o (branch_y * lru_out)
    RG-LRU: r_t = sigmoid(W_r u + b_r); i_t = sigmoid(W_i u + b_i)
            a_t = exp(c * softplus(Lambda) * (-r_t))        (c = 8)
            h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

A multi-step call (train, prefill) runs the diagonal recurrence through
`kernels.rglru_scan` with h0 passed in, where the reference folds h0
into b[:, 0] and runs `jax.lax.associative_scan`: the same function. A
one-token decode takes a single elementwise step. The mLSTM and sLSTM
blocks (xLSTM) are not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models.layers import (F32, cdtype, dense_init, rmsnorm,
                                       rmsnorm_init)

PyTree = Any

_RGLRU_C = 8.0
_CONV_W = 4


def rglru_init(gen, cfg, device, lead: tuple = ()) -> PyTree:
    d = cfg.d_model
    dt = cdtype(cfg)
    lead = tuple(lead)
    # Lambda init so a^c spans (0.9, 0.999) like the paper
    lam = 0.9 + (0.999 - 0.9) * torch.rand(lead + (d,), generator=gen,
                                           device=device, dtype=F32)
    lam_param = torch.log(torch.exp(-torch.log(lam) / _RGLRU_C) - 1.0)
    return {
        "norm": rmsnorm_init(d, device, lead),
        "wx": dense_init(gen, (d, d), d, dt, device, lead),
        "wy": dense_init(gen, (d, d), d, dt, device, lead),
        "wo": dense_init(gen, (d, d), d, dt, device, lead),
        "conv": dense_init(gen, (_CONV_W, d), _CONV_W, dt, device, lead)
        / math.sqrt(_CONV_W),
        "w_r": dense_init(gen, (d, d), d, dt, device, lead),
        "w_i": dense_init(gen, (d, d), d, dt, device, lead),
        "b_r": torch.zeros(lead + (d,), dtype=dt, device=device),
        "b_i": torch.zeros(lead + (d,), dtype=dt, device=device),
        "lam": lam_param,
    }


def _causal_conv(w: torch.Tensor, x: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width 4, in x's dtype. x: (B,S,D); state:
    (B, W-1, D). Returns (out, new state)."""
    B, S, D = x.shape
    if state is None:
        state = torch.zeros((B, _CONV_W - 1, D), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, _CONV_W):
        out = out + xp[:, i:i + S] * w[i]
    # a copy: the cache must not keep the whole (B, S+3, D) input alive
    return out, xp[:, -(_CONV_W - 1):].clone()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) with no linear cut-over (jax.nn.softplus)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_gates(params: PyTree, u: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_a, beta*i*u) in f32. u: (B,S,D)."""
    r = torch.sigmoid(torch.matmul(u, params["w_r"]).to(F32)
                      + params["b_r"].to(F32))
    i = torch.sigmoid(torch.matmul(u, params["w_i"]).to(F32)
                      + params["b_i"].to(F32))
    log_a = -_RGLRU_C * _softplus(params["lam"]) * r       # (B,S,D) f32
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    return log_a, beta * i * u.to(F32)


def rglru_apply(params: PyTree, x: torch.Tensor, cfg, *, mode: str,
                layer_cache: Optional[PyTree] = None
                ) -> tuple[torch.Tensor, Optional[PyTree]]:
    B, S, D = x.shape
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    y_branch = F.gelu(torch.matmul(h, params["wy"]), approximate="tanh")
    u = torch.matmul(h, params["wx"])
    conv_state = None if layer_cache is None else layer_cache["conv"]
    u, new_conv = _causal_conv(params["conv"], u, conv_state)
    log_a, b = _rglru_gates(params, u)

    h0 = (torch.zeros((B, D), dtype=F32, device=x.device)
          if layer_cache is None else layer_cache["h"])
    if mode == "decode" and S == 1:
        a = torch.exp(log_a[:, 0])
        h_new = a * h0 + b[:, 0]
        states = h_new[:, None]
    else:
        states, h_new = rglru_scan(h0, torch.exp(log_a), b)

    out = torch.matmul(y_branch * states.to(x.dtype), params["wo"])
    cache = None
    if layer_cache is not None:
        cache = {"h": h_new, "conv": new_conv}
    return out, cache


def init_rglru_cache(cfg, batch: int, dtype, device, lead: tuple = ()
                     ) -> PyTree:
    d = cfg.d_model
    lead = tuple(lead)
    return {"h": torch.zeros(lead + (batch, d), dtype=F32, device=device),
            "conv": torch.zeros(lead + (batch, _CONV_W - 1, d), dtype=dtype,
                                device=device)}
