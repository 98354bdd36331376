"""Wrapper for the fused dequant + masked-aggregate kernel.

`wire_aggregate` takes one leaf's stacked wire payloads (C workers) and
returns the aggregated dense delta of the leaf's shape — the Aggregate
half of the packed wire route (`comm.channel.receive_packed`).

Dispatch is by the device of the payload: CPU tensors take the plain
version (ref.py), CUDA tensors launch csrc/wire_agg.cu (or raise). All
C workers go through one pass; the JAX package's chunked tree mean for
C > 64 (a TPU VMEM limit) has no counterpart here, so at C > 64 the
port's mean differs from it only in summation order.

The launch is `_plan`'s: a CTA per strip of packed rows, 1 or 4 payload
bytes a thread, all C workers' bytes of the strip staged by one TMA
copy, or in chunks through a ring of two stages when C is over a TMA
box (256) or the strip's bytes overflow shared memory.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.sharding import boundary
from repro_torch.sharding.rules import is_dtensor
from repro_torch.kernels.quant_pack.ref import BLOCK_ROWS, LANES
from repro_torch.kernels.wire_agg.ref import (AGGREGATORS, TREE_MODES,
                                              wire_agg_ref)

_MODES = {"mean": 0, "sum": 1, "median": 2, "trimmed_mean": 3}
# a 16-byte record a worker in shared memory, 64 KB at this cap, beside
# a ring of two stages of 82+ workers' strips
MAX_WORKERS = 4000
MAX_ROBUST = 64           # the robust modes' sort (csrc kMaxRobust)
SMEM_MAX = 232_448        # shared memory a Hopper block may use
BOX_MAX = 256             # elements along each dimension of a TMA box
MIN_CTAS = 512            # strips are widened only while this many remain
_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclass(frozen=True)
class AggPlan:
    strip: int            # packed rows a CTA (1, 2, 4, 8)
    vec: int              # payload bytes a thread (1 or 4)
    chunk: int            # workers a stage (a TMA box: <= 256)
    stages: int           # 1: all C at once; 2: a ring of chunks
    grid: int             # CTAs: packed rows / strip
    threads: int          # strip x 128 / vec
    smem: int             # dynamic shared memory bytes


def _smem(C: int, strip: int, chunk: int, stages: int) -> int:
    """As csrc/wire_agg.cu `plan_smem`: alignment slack, the stages, a
    16-byte record a worker, an mbarrier a stage, each chunk's first
    record and the count."""
    return (128 + stages * chunk * strip * LANES + 16 * C + 8 * stages
            + 4 * (-(-C // chunk) + 1))


def _plan(C: int, rows: int, bits: int, aggregator: str = "mean"
          ) -> AggPlan:
    """The launch of csrc/wire_agg.cu for C payloads of (rows, 128)
    outputs. Under MIN_CTAS packed rows (the paper's one-block leaves) a
    CTA takes one row, a thread one byte; else a thread takes 4 bytes and
    a strip is the widest of 8, 4, 2 packed rows that leaves MIN_CTAS
    strips. All C workers go in one TMA box when they fit a box (256) and
    shared memory, else in even chunks through a ring of two stages.
    Raises ValueError on what the kernel or the card does not take."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if aggregator not in TREE_MODES:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    if rows < BLOCK_ROWS or rows % BLOCK_ROWS:
        raise ValueError(f"wire_agg: rows {rows} is not a positive multiple "
                         f"of {BLOCK_ROWS}")
    if not 1 <= C <= MAX_WORKERS:
        raise ValueError(f"wire_agg: C={C} workers is outside 1..{MAX_WORKERS}")
    if aggregator in ("median", "trimmed_mean") and C > MAX_ROBUST:
        raise ValueError(f"wire_agg: {aggregator} sorts at most {MAX_ROBUST} "
                         f"workers per thread, got C={C}")
    prow = rows // 2 if bits == 4 else rows
    if prow < MIN_CTAS:
        strip, vec = 1, 1
    else:
        strip, vec = next(s for s in (8, 4, 2, 1) if prow // s >= MIN_CTAS), 4
    if C <= BOX_MAX and _smem(C, strip, C, 1) <= SMEM_MAX:
        chunk, stages = C, 1
    else:
        chunk = BOX_MAX
        while _smem(C, strip, chunk, 2) > SMEM_MAX:
            chunk -= 1
        chunk = -(-C // -(-C // chunk))   # even chunks: no empty box slots
        stages = 2
    return AggPlan(strip, vec, chunk, stages, prow // strip,
                   strip * LANES // vec, _smem(C, strip, chunk, stages))


def _lib() -> ctypes.CDLL:
    lib = runtime.library("wire_agg")
    if lib.wa_wire_agg.argtypes is None:
        lib.wa_wire_agg.argtypes = [_P] * 5 + [_I] * 4 + [
            ctypes.c_float] + [_I] * 6 + [_P]
        lib.wa_wire_agg.restype = _I
    return lib


def wire_agg_2d(packed: torch.Tensor, scales: torch.Tensor,
                mask: torch.Tensor, weights: torch.Tensor, *, bits: int = 8,
                aggregator: str = "mean", trim_ratio: float = 0.1
                ) -> torch.Tensor:
    """packed (C, rows, 128) int8 / (C, rows/2, 128) uint8, scales (C,
    nb) f32, mask and weights (C,) f32 -> (rows, 128) f32."""
    if aggregator not in TREE_MODES:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    cpu = packed.device.type == "cpu"
    runtime.note_dispatch("wire_agg", cpu, bits=bits, aggregator=aggregator,
                          workers=packed.shape[0])
    if cpu:
        return wire_agg_ref(packed, scales, mask, weights, bits=bits,
                            aggregator=aggregator, trim_ratio=trim_ratio)
    if packed.device.type != "cuda":
        raise ValueError(f"no kernel for device {packed.device}")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    C, prow, lanes = packed.shape
    rows = prow * (2 if bits == 4 else 1)
    if lanes != LANES or rows % BLOCK_ROWS:
        raise ValueError(f"wire_agg: bad packed shape {tuple(packed.shape)}")
    plan = _plan(C, rows, bits, aggregator)
    lib = _lib()
    dev = packed.device
    runtime.require(packed, torch.int8 if bits == 8 else torch.uint8,
                    (C, prow, LANES), "wire_agg packed", dev)
    runtime.require(scales, torch.float32, (C, rows // BLOCK_ROWS),
                    "wire_agg scales", dev)
    runtime.require(mask, torch.float32, (C,), "wire_agg mask", dev)
    runtime.require(weights, torch.float32, (C,), "wire_agg weights", dev)
    if packed.data_ptr() % 16:
        raise ValueError("wire_agg packed: not 16-byte aligned (TMA)")
    out = torch.empty((rows, LANES), dtype=torch.float32, device=dev)
    err = lib.wa_wire_agg(packed.data_ptr(), scales.data_ptr(),
                          mask.data_ptr(), weights.data_ptr(),
                          out.data_ptr(), C, rows, bits, _MODES[aggregator],
                          float(np.float32(trim_ratio)), plan.strip,
                          plan.vec, plan.chunk, plan.stages, plan.grid,
                          plan.smem,
                          runtime.stream_ptr(packed))
    runtime.check(err, "wire_agg")
    runtime.note_launch("wire_agg", workers=C)
    return out


def wire_aggregate(packed: torch.Tensor, scales: torch.Tensor,
                   mask: torch.Tensor, *, shape: tuple, bits: int = 8,
                   aggregator: str = "mean", trim_ratio: float = 0.1,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Aggregate C packed payloads of one leaf into a dense f32 delta of
    `shape` — `channel.receive`'s aggregate term before the += into the
    global params. mask: (C,) delivery mask; weights: optional (C,)
    per-worker weights (None = ones). DTensor inputs are gathered and
    every rank aggregates them all (`sharding.boundary.replicated`)."""
    if any(is_dtensor(t) for t in (packed, scales, mask, weights)):
        return boundary.replicated(
            "wire_agg", lambda p, s, m, w: wire_aggregate(
                p, s, m, shape=shape, bits=bits, aggregator=aggregator,
                trim_ratio=trim_ratio, weights=w),
            (packed, scales, mask, weights))
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    C = packed.shape[0]
    mask2 = mask.to(torch.float32).reshape(C).contiguous()
    w2 = (torch.ones(C, dtype=torch.float32, device=packed.device)
          if weights is None
          else weights.to(torch.float32).reshape(C).contiguous())
    x2 = wire_agg_2d(packed, scales, mask2, w2, bits=bits,
                     aggregator=aggregator, trim_ratio=trim_ratio)
    n = 1
    for s in shape:
        n *= s
    return x2.reshape(-1)[:n].reshape(tuple(shape))
