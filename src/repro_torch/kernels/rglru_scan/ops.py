"""Wrappers for the linear-recurrence scan kernel (RG-LRU core) and its
backward.

`rglru_scan(h0, a, b)` returns (states, final) as the JAX package's
`kernels.rglru_scan.ops.rglru_scan` does. The launches are operators
(`runtime.register_op`: repro_torch::rglru_scan, rglru_scan_bwd): the
dispatcher sends a CPU tensor to the plain versions (ref.py), a CUDA
tensor to csrc/rglru_scan.cu (or raises), a fake one to the shape
rule. The kernel takes any sequence length, so there is no
identity-step padding. When a gradient is wanted
the scan runs under `_Scan`, an autograd Function whose backward is
`rglru_scan_bwd_raw` (csrc/rglru_scan_bwd.cu on a card, the plain
reverse loop on the CPU); the reference gets that gradient from XLA's
autodiff of its associative scan.

The launch geometry is `_plan`'s and `_bwd_plan`'s, pure functions of
the shape: each CTA scans one (batch, channel tile) over the whole
sequence, forward or in reverse, fed by TMA in stages of STAGE_ROWS
time rows.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import runtime
from repro_torch.sharding import boundary
from repro_torch.sharding.rules import is_dtensor
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int

SMEM_MAX = 232_448        # shared memory a Hopper block may use
BOX_MAX = 256             # elements along each dimension of a TMA box
# the kernels' constants (csrc/rglru_scan.cu and rglru_scan_bwd.cu kTile,
# kStageRows, kStages, kOutStages): 128 channels a CTA (128 CTAs at B 4,
# D 4096: one an SM), 32 time rows a stage, 4 forward stages of a and b
# (32 KiB each) in flight, 3 backward stages of g, a and the states
# (48 KiB each); two output stages each way
TILE = 128
STAGE_ROWS = 32
STAGES = 4
BWD_STAGES = 3
OUT_STAGES = 2
STATIC_SMEM = 2 * STAGES * 8              # the forward's mbarriers
BWD_STATIC_SMEM = 2 * BWD_STAGES * 8      # the backward's
_BUF = STAGE_ROWS * TILE * 4              # bytes of one (rows, tile) box
SMEM = (2 * STAGES + OUT_STAGES) * _BUF + 1024
BWD_SMEM = (3 * BWD_STAGES + 2 * OUT_STAGES) * _BUF + 1024


@dataclass(frozen=True)
class ScanPlan:
    tile: int             # channels a CTA scans (one consumer thread each)
    stage_rows: int       # time rows a stage holds
    stages: int           # input stages in flight
    grid: tuple[int, int]  # (channel tiles, batch)
    threads: int          # consumers + one producer warp
    smem: int             # dynamic shared memory bytes


def _check_shape(what: str, B: int, S: int, D: int) -> None:
    if B < 1 or S < 1 or D < 1:
        raise ValueError(f"{what}: empty shape {(B, S, D)}")
    if D % 4:
        raise ValueError(f"{what}: D = {D} is not a multiple of 4 (the "
                         f"TMA maps' row stride must be a multiple of 16 B)")
    if B > 65535:
        raise ValueError(f"{what}: batch {B} over the grid's 65535")


def _plan(B: int, S: int, D: int) -> ScanPlan:
    """The launch of csrc/rglru_scan.cu for states (B, S, D). Raises
    ValueError on a shape the kernel does not take."""
    _check_shape("rglru_scan", B, S, D)
    return ScanPlan(TILE, STAGE_ROWS, STAGES, (-(-D // TILE), B), TILE + 32,
                    SMEM)


def _bwd_plan(B: int, S: int, D: int) -> ScanPlan:
    """The launch of csrc/rglru_scan_bwd.cu for states (B, S, D): the
    forward's grid, walked in reverse, with three input boxes a stage (g,
    a, and the states one row earlier) and two outputs (da, db). Raises
    ValueError on a shape the kernel does not take."""
    _check_shape("rglru_scan_bwd", B, S, D)
    return ScanPlan(TILE, STAGE_ROWS, BWD_STAGES, (-(-D // TILE), B),
                    TILE + 32, BWD_SMEM)


def _lib() -> ctypes.CDLL:
    lib = runtime.library("rglru_scan")
    if lib.rs_rglru_scan.argtypes is None:
        lib.rs_rglru_scan.argtypes = [_P, _P, _P, _P] + [_I] * 9 + [_P]
        lib.rs_rglru_scan.restype = _I
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = runtime.library("rglru_scan_bwd")
    if lib.rs_rglru_scan_bwd.argtypes is None:
        lib.rs_rglru_scan_bwd.argtypes = [_P] * 7 + [_I] * 9 + [_P]
        lib.rs_rglru_scan_bwd.restype = _I
    return lib


def _aligned(what: str, *ts: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: inputs must be 16-byte aligned (TMA)")


def _scan_cuda(h0, a, b):
    runtime.require_cuda(a)
    B, S, D = a.shape
    dev = a.device
    runtime.require(h0, torch.float32, (B, D), "rglru_scan h0", dev)
    runtime.require(a, torch.float32, (B, S, D), "rglru_scan a", dev)
    runtime.require(b, torch.float32, (B, S, D), "rglru_scan b", dev)
    plan = _plan(B, S, D)
    _aligned("rglru_scan", a, b)
    out = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    err = _lib().rs_rglru_scan(h0.data_ptr(), a.data_ptr(), b.data_ptr(),
                               out.data_ptr(), B, S, D, plan.tile,
                               plan.stage_rows, plan.stages, *plan.grid,
                               plan.smem, runtime.stream_ptr(a))
    runtime.check(err, "rglru_scan")
    runtime.note_launch("rglru_scan")
    return out


def _scan_bwd_cuda(h0, a, states, g):
    runtime.require_cuda(a)
    B, S, D = a.shape
    dev = a.device
    runtime.require(h0, torch.float32, (B, D), "rglru_scan_bwd h0", dev)
    for t, what in ((a, "a"), (states, "states"), (g, "g")):
        runtime.require(t, torch.float32, (B, S, D), f"rglru_scan_bwd {what}",
                        dev)
    plan = _bwd_plan(B, S, D)
    _aligned("rglru_scan_bwd", a, states, g)
    da = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    db = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, D), dtype=torch.float32, device=dev)
    err = _bwd_lib().rs_rglru_scan_bwd(
        h0.data_ptr(), a.data_ptr(), states.data_ptr(), g.data_ptr(),
        dh0.data_ptr(), da.data_ptr(), db.data_ptr(), B, S, D, plan.tile,
        plan.stage_rows, plan.stages, *plan.grid, plan.smem,
        runtime.stream_ptr(a))
    runtime.check(err, "rglru_scan_bwd")
    runtime.note_launch("rglru_scan_bwd")
    return dh0, da, db


def _scan_fake(h0, a, b):
    B, S, D = a.shape
    _plan(B, S, D)
    return a.new_empty((B, S, D), dtype=torch.float32)


def _scan_bwd_fake(h0, a, states, g):
    B, S, D = a.shape
    _bwd_plan(B, S, D)
    f32 = torch.float32
    return (a.new_empty((B, D), dtype=f32), a.new_empty((B, S, D), dtype=f32),
            a.new_empty((B, S, D), dtype=f32))


def _scan_cost(h0, a, b):
    """2 operations a state; a and b in, the states out (f32), h0 in and
    its (B, D) once more."""
    B, S, D = a.shape
    n = B * S * D
    return 2 * n, 12 * n + 8 * B * D


def _scan_bwd_cost(h0, a, states, g):
    """3 operations a state; a, the states and g in, da and db out (f32),
    h0 in and dh0 out."""
    B, S, D = a.shape
    n = B * S * D
    return 3 * n, 20 * n + 8 * B * D


RGLRU_SCAN = runtime.register_op(
    "rglru_scan", "(Tensor h0, Tensor a, Tensor b) -> Tensor",
    cuda=_scan_cuda, cpu=rglru_scan_ref, fake=_scan_fake, cost=_scan_cost)
RGLRU_SCAN_BWD = runtime.register_op(
    "rglru_scan_bwd",
    "(Tensor h0, Tensor a, Tensor states, Tensor g) -> (Tensor, Tensor, "
    "Tensor)",
    cuda=_scan_bwd_cuda, cpu=rglru_scan_bwd_ref, fake=_scan_bwd_fake,
    cost=_scan_bwd_cost)


def rglru_scan_raw(h0: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """h0 (B, D), a and b (B, S, D), all f32 -> states (B, S, D) f32."""
    return (_scan_cuda if runtime.direct(a) else RGLRU_SCAN)(h0, a, b)


def rglru_scan_bwd_raw(h0: torch.Tensor, a: torch.Tensor,
                       states: torch.Tensor, g: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h0 (B, D), a, states and g (the gradient of the states) (B, S, D),
    all f32 -> (dh0 (B, D), da, db (B, S, D)) f32."""
    fn = _scan_bwd_cuda if runtime.direct(a) else RGLRU_SCAN_BWD
    return fn(h0, a, states, g)


class _Scan(torch.autograd.Function):
    """The scan with its backward kernel. Saves h0, a and the states
    (what the backward reads); b is not needed."""

    @staticmethod
    def forward(ctx, h0, a, b):
        states = rglru_scan_raw(h0, a, b)
        ctx.save_for_backward(h0, a, states)
        return states

    @staticmethod
    def backward(ctx, g):
        h0, a, states = ctx.saved_tensors
        g = g.contiguous()
        if g.data_ptr() % 16:          # a view at an odd offset (TMA)
            g = g.clone()
        dh0, da, db = rglru_scan_bwd_raw(h0, a, states, g)
        return (dh0 if ctx.needs_input_grad[0] else None,
                da if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None)


def rglru_scan(h0: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """h0: (B, D); a, b: (B, S, D) with S >= 1. Returns (states (B, S, D)
    f32, final state (B, D) f32), differentiable in h0, a and b. DTensor
    inputs run on each rank's batch or channel shards
    (`sharding.boundary.scan`)."""
    if is_dtensor(h0) or is_dtensor(a) or is_dtensor(b):
        return boundary.scan(rglru_scan, h0, a, b)
    f32 = torch.float32
    args = (h0.to(f32).contiguous(), a.to(f32).contiguous(),
            b.to(f32).contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        states = _Scan.apply(*args)
    else:
        states = rglru_scan_raw(*args)
    # a copy, so that a cache holding the final state does not keep the
    # whole (B, S, D) states alive; its gradient reaches the backward
    # through the states
    return states, states[:, -1].clone()
