"""Wrapper for the fused dequant + masked-aggregate kernel.

`wire_aggregate` takes one leaf's stacked wire payloads (C workers) and
returns the aggregated dense delta of the leaf's shape — the Aggregate
half of the packed wire route (`comm.channel.receive_packed`).

Dispatch is by the device of the payload: CPU tensors take the plain
version (ref.py), CUDA tensors launch csrc/wire_agg.cu (or raise). All
C workers go through one pass; the JAX package's chunked tree mean for
C > 64 (a TPU VMEM limit) has no counterpart here, so at C > 64 the
port's mean differs from it only in summation order.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.quant_pack.ref import BLOCK_ROWS, LANES
from repro_torch.kernels.wire_agg.ref import (AGGREGATORS, TREE_MODES,
                                              wire_agg_ref)

_MODES = {"mean": 0, "sum": 1, "median": 2, "trimmed_mean": 3}
# dynamic shared memory holds 3 floats per worker (plus 8 static bytes)
# within the 48 KiB a block gets without opt-in
MAX_WORKERS = 4000
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = runtime.library("wire_agg")
    if lib.wa_wire_agg.argtypes is None:
        lib.wa_wire_agg.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    ctypes.c_float, _P]
        lib.wa_wire_agg.restype = _I
        lib.wa_max_robust_workers.argtypes = []
        lib.wa_max_robust_workers.restype = _I
    return lib


def wire_agg_2d(packed: torch.Tensor, scales: torch.Tensor,
                mask: torch.Tensor, weights: torch.Tensor, *, bits: int = 8,
                aggregator: str = "mean", trim_ratio: float = 0.1
                ) -> torch.Tensor:
    """packed (C, rows, 128) int8 / (C, rows/2, 128) uint8, scales (C,
    nb) f32, mask and weights (C,) f32 -> (rows, 128) f32."""
    if aggregator not in TREE_MODES:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    if packed.device.type == "cpu":
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
    lib = _lib()
    if C > MAX_WORKERS:
        raise ValueError(f"wire_agg: C={C} workers exceeds {MAX_WORKERS}")
    if aggregator in ("median", "trimmed_mean") and \
            C > lib.wa_max_robust_workers():
        raise ValueError(f"wire_agg: {aggregator} sorts at most "
                         f"{lib.wa_max_robust_workers()} workers per "
                         f"thread, got C={C}")
    dev = packed.device
    runtime.require(packed, torch.int8 if bits == 8 else torch.uint8,
                    (C, prow, LANES), "wire_agg packed", dev)
    runtime.require(scales, torch.float32, (C, rows // BLOCK_ROWS),
                    "wire_agg scales", dev)
    runtime.require(mask, torch.float32, (C,), "wire_agg mask", dev)
    runtime.require(weights, torch.float32, (C,), "wire_agg weights", dev)
    out = torch.empty((rows, LANES), dtype=torch.float32, device=dev)
    err = lib.wa_wire_agg(packed.data_ptr(), scales.data_ptr(),
                          mask.data_ptr(), weights.data_ptr(),
                          out.data_ptr(), C, rows, bits, _MODES[aggregator],
                          float(np.float32(trim_ratio)),
                          runtime.stream_ptr(packed))
    runtime.check(err, "wire_agg")
    runtime.note_launch("wire_agg")
    return out


def wire_aggregate(packed: torch.Tensor, scales: torch.Tensor,
                   mask: torch.Tensor, *, shape: tuple, bits: int = 8,
                   aggregator: str = "mean", trim_ratio: float = 0.1,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Aggregate C packed payloads of one leaf into a dense f32 delta of
    `shape` — `channel.receive`'s aggregate term before the += into the
    global params. mask: (C,) delivery mask; weights: optional (C,)
    per-worker weights (None = ones)."""
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
