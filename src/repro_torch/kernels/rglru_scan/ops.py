"""Wrapper for the linear-recurrence scan kernel (RG-LRU core).

`rglru_scan(h0, a, b)` returns (states, final) as the JAX package's
`kernels.rglru_scan.ops.rglru_scan` does. Dispatch is by the device of
`a`: a CPU tensor takes the plain version (ref.py), a CUDA tensor
launches csrc/rglru_scan.cu (or raises). The kernel takes any sequence
length, so there is no identity-step padding. Forward only: there is no
backward kernel yet (a RecurrentGemma training slice needs one), and
asking for a gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = runtime.library("rglru_scan")
    if lib.rs_rglru_scan.argtypes is None:
        lib.rs_rglru_scan.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
        lib.rs_rglru_scan.restype = _I
    return lib


def rglru_scan_raw(h0: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """h0 (B, D), a and b (B, S, D), all f32 -> states (B, S, D) f32."""
    if a.device.type == "cpu":
        return rglru_scan_ref(h0, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    B, S, D = a.shape
    dev = a.device
    runtime.require(h0, torch.float32, (B, D), "rglru_scan h0", dev)
    runtime.require(a, torch.float32, (B, S, D), "rglru_scan a", dev)
    runtime.require(b, torch.float32, (B, S, D), "rglru_scan b", dev)
    out = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    err = _lib().rs_rglru_scan(h0.data_ptr(), a.data_ptr(), b.data_ptr(),
                               out.data_ptr(), B, S, D,
                               runtime.stream_ptr(a))
    runtime.check(err, "rglru_scan")
    runtime.note_launch("rglru_scan")
    return out


def rglru_scan(h0: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """h0: (B, D); a, b: (B, S, D) with S >= 1. Returns (states (B, S, D)
    f32, final state (B, D) f32)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h0, a, b)):
        raise NotImplementedError(
            "rglru_scan is forward-only: its backward kernel comes with "
            "a RecurrentGemma training slice")
    f32 = torch.float32
    states = rglru_scan_raw(h0.to(f32).contiguous(), a.to(f32).contiguous(),
                            b.to(f32).contiguous())
    # a copy, so that a cache holding the final state does not keep the
    # whole (B, S, D) states alive
    return states, states[:, -1].clone()
