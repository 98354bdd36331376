"""Plain PyTorch version of the linear-recurrence scan (the oracle of
csrc/rglru_scan.cu and of the JAX package's `rglru_scan_ref`)."""
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
