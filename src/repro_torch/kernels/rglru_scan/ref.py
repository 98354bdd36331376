"""Plain PyTorch versions of the linear-recurrence scan and of its
backward (the oracles of csrc/rglru_scan.cu and csrc/rglru_scan_bwd.cu,
and of the JAX package's `rglru_scan_ref` and of XLA's autodiff of its
associative scan)."""
from __future__ import annotations

import torch


def rglru_scan_ref(h0: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Sequential h_t = a_t h_{t-1} + b_t in f32. h0: (B, D); a, b:
    (B, S, D). Returns the states (B, S, D) f32. A multiply then an add,
    each rounded: the CUDA kernel reproduces it bit for bit."""
    h = h0.to(torch.float32)
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(h0: torch.Tensor, a: torch.Tensor,
                       states: torch.Tensor, g: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `rglru_scan_ref` for the upstream gradient g of
    the states, all f32: h0 (B, D), a, states, g (B, S, D). The reverse
    walk, with dh the gradient reaching h_t:

        dh_{S-1} = g_{S-1};  dh_t = g_t + a_{t+1} dh_{t+1}
        db_t = dh_t;  da_t = dh_t h_{t-1} (h_{-1} = h0);  dh0 = a_0 dh_0

    Returns (dh0, da, db). A multiply then an add, each rounded, and dh
    starts at 0 with a_S = 0 (so dh_{S-1} = g_{S-1} + 0 * 0): the CUDA
    kernel, whose zero-filled rows past S walk the same steps first,
    reproduces it bit for bit."""
    f32 = torch.float32
    a, states, g = a.to(f32), states.to(f32), g.to(f32)
    h0 = h0.to(f32)
    da = torch.empty(a.shape, dtype=f32, device=a.device)
    db = torch.empty(a.shape, dtype=f32, device=a.device)
    dh = torch.zeros_like(h0)
    a_next = torch.zeros_like(h0)
    for t in range(a.shape[1] - 1, -1, -1):
        dh = g[:, t] + a_next * dh
        db[:, t] = dh
        da[:, t] = dh * (states[:, t - 1] if t else h0)
        a_next = a[:, t]
    return a_next * dh, da, db
