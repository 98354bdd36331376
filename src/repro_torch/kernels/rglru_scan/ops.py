"""Wrapper for the linear-recurrence scan kernel (RG-LRU core).

`rglru_scan(h0, a, b)` returns (states, final) as the JAX package's
`kernels.rglru_scan.ops.rglru_scan` does. Dispatch is by the device of
`a`: a CPU tensor takes the plain version (ref.py), a CUDA tensor
launches csrc/rglru_scan.cu (or raises). The kernel takes any sequence
length, so there is no identity-step padding. Forward only: there is no
backward kernel yet (a RecurrentGemma training slice needs one), and
asking for a gradient raises.

The launch geometry is `_plan`'s, a pure function of the shape: the
kernel's CTAs each scan one (batch, channel tile) over the whole
sequence, fed STAGES stages of STAGE_ROWS time rows by TMA.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

_P = ctypes.c_void_p
_I = ctypes.c_int

SMEM_MAX = 232_448        # shared memory a Hopper block may use
BOX_MAX = 256             # elements along each dimension of a TMA box
# the kernel's constants (csrc/rglru_scan.cu kTile, kStageRows, kStages,
# kOutStages): 128 channels a CTA (128 CTAs at B 4, D 4096: one an SM),
# 32 time rows a stage (a 32 KiB stage of a and b), 4 stages in flight
TILE = 128
STAGE_ROWS = 32
STAGES = 4
OUT_STAGES = 2
STATIC_SMEM = 2 * STAGES * 8              # the kernel's mbarriers
SMEM = (2 * STAGES + OUT_STAGES) * STAGE_ROWS * TILE * 4 + 1024


@dataclass(frozen=True)
class ScanPlan:
    tile: int             # channels a CTA scans (one consumer thread each)
    stage_rows: int       # time rows a stage holds
    stages: int           # input stages in flight
    grid: tuple[int, int]  # (channel tiles, batch)
    threads: int          # consumers + one producer warp
    smem: int             # dynamic shared memory bytes


def _plan(B: int, S: int, D: int) -> ScanPlan:
    """The launch of csrc/rglru_scan.cu for states (B, S, D). Raises
    ValueError on a shape the kernel does not take."""
    if B < 1 or S < 1 or D < 1:
        raise ValueError(f"rglru_scan: empty shape {(B, S, D)}")
    if D % 4:
        raise ValueError(f"rglru_scan: D = {D} is not a multiple of 4 (the "
                         f"TMA maps' row stride must be a multiple of 16 B)")
    if B > 65535:
        raise ValueError(f"rglru_scan: batch {B} over the grid's 65535")
    return ScanPlan(TILE, STAGE_ROWS, STAGES, (-(-D // TILE), B), TILE + 32,
                    SMEM)


def _lib() -> ctypes.CDLL:
    lib = runtime.library("rglru_scan")
    if lib.rs_rglru_scan.argtypes is None:
        lib.rs_rglru_scan.argtypes = [_P, _P, _P, _P] + [_I] * 9 + [_P]
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
    plan = _plan(B, S, D)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("rglru_scan: a and b must be 16-byte aligned (TMA)")
    out = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    err = _lib().rs_rglru_scan(h0.data_ptr(), a.data_ptr(), b.data_ptr(),
                               out.data_ptr(), B, S, D, plan.tile,
                               plan.stage_rows, plan.stages, *plan.grid,
                               plan.smem, runtime.stream_ptr(a))
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
