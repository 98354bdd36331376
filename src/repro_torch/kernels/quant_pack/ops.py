"""Wrappers for the quantize-pack kernel family: the CUDA launchers
(csrc/quant_pack.cu, bound through ctypes) and the leaf-level functions
that flatten a stacked (C, *leaf) array to the kernels' (C, rows, 128)
layout, pad it to whole (256, 128) blocks, and undo that on the way out.

Every function takes a leading worker dimension C: the kernels run all
workers of a leaf in one launch (grid over block x worker), where the
JAX package vmaps a per-worker call. The downlink passes C = 1.

Each launch is an operator (`runtime.register_op`: repro_torch::
quant_pack, quant_pack_ef, dequant_unpack), so the dispatcher picks by
the device: CPU tensors take the plain versions in ref.py, CUDA tensors
launch the kernel (or raise), fake tensors get the outputs' shapes. Each
2D wrapper reports its dispatch to the obs bus (`runtime.note_dispatch`).

The quantize-pack launch is `_plan`'s: each (256, 128) tile and worker
is split over a cluster of 8 CTAs, each owning 32 of the tile's rows
(which rows is the kernel's `vec_index`). The decode's is
`_dequant_plan`'s: a 2D grid over (tile parts, worker), each warp one
512-byte payload chunk, 16 bytes a lane.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import runtime
from repro_torch.sharding import boundary
from repro_torch.sharding.rules import is_dtensor
from repro_torch.kernels.quant_pack.ref import (BLOCK_ROWS, LANES,
                                                dequant_unpack_ref,
                                                quant_pack_ef_ref,
                                                quant_pack_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int

CLUSTER = 8               # CTAs a tile (the portable cluster size)
DQ_THREADS = 256          # dequant_kernel's threads a CTA (kDqThreads)
DQ_CHUNK = 512            # payload bytes a warp decodes, 16 a lane


@dataclass(frozen=True)
class PackPlan:
    cluster: int          # CTAs a (256, 128) tile, one cluster
    cta_rows: int         # tile rows each CTA quantizes
    grid: tuple[int, int]  # (cluster x tiles per worker leaf, C)


def _plan(C: int, rows: int, bits: int) -> PackPlan:
    """The launch of quant_pack_kernel for (C, rows, 128): one cluster
    of CLUSTER CTAs per tile and worker. Raises ValueError on what the
    kernel or the card does not take."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if C < 1 or rows < BLOCK_ROWS or rows % BLOCK_ROWS:
        raise ValueError(f"quant_pack: rows {rows} is not a positive "
                         f"multiple of {BLOCK_ROWS} (C = {C})")
    if C > 65535:
        raise ValueError(f"quant_pack: C = {C} over the grid's 65535")
    return PackPlan(CLUSTER, BLOCK_ROWS // CLUSTER,
                    (CLUSTER * (rows // BLOCK_ROWS), C))


@dataclass(frozen=True)
class DequantPlan:
    threads: int          # threads a CTA
    parts: int            # CTAs a (256, 128) tile
    grid: tuple[int, int]  # (parts x tiles per worker leaf, C)


def _dequant_plan(C: int, rows: int, bits: int) -> DequantPlan:
    """The launch of dequant_kernel for (C, rows, 128) outputs: a tile's
    payload (32 KiB int8, 16 KiB int4) in 512-byte chunks, one a warp,
    8 warps a CTA (8 CTAs a tile at int8, 4 at int4). Raises ValueError
    on what the kernel or the card does not take."""
    _plan(C, rows, bits)                  # the same shape rules
    chunks = BLOCK_ROWS * LANES // (8 // bits) // DQ_CHUNK
    parts = chunks // (DQ_THREADS // 32)
    return DequantPlan(DQ_THREADS, parts, (parts * (rows // BLOCK_ROWS), C))


def _lib() -> ctypes.CDLL:
    lib = runtime.library("quant_pack")
    if lib.qp_quant_pack.argtypes is None:
        lib.qp_quant_pack.argtypes = [_P] * 6 + [_I] * 7 + [_P]
        lib.qp_quant_pack.restype = _I
        lib.qp_dequant_unpack.argtypes = [_P, _P, _P] + [_I] * 7 + [_P]
        lib.qp_dequant_unpack.restype = _I
    return lib


def _pack_plan(x, bits, name) -> PackPlan:
    """`_plan` of (C, rows, 128) x: the launch's and the shape rule's
    checks."""
    C, rows, lanes = x.shape
    if lanes != LANES:
        raise ValueError(f"{name}: x must be (C, rows, 128), got "
                         f"{tuple(x.shape)}")
    return _plan(C, rows, bits)


def _launch_quant_pack(x, residual, seeds, bits, name):
    runtime.require_cuda(x)
    plan = _pack_plan(x, bits, name)
    C, rows, _ = x.shape
    dev = x.device
    runtime.require(x, torch.float32, (C, rows, LANES), f"{name} x", dev)
    if residual is not None:
        runtime.require(residual, torch.float32, (C, rows, LANES),
                        f"{name} residual", dev)
    runtime.require(seeds, torch.int32, (C,), f"{name} seeds", dev)
    packed, scales = _pack_outputs(x, bits)
    res = (None if residual is None
           else torch.empty((C, rows, LANES), dtype=torch.float32, device=dev))
    err = _lib().qp_quant_pack(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        seeds.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        None if res is None else res.data_ptr(), C, rows, bits, plan.cluster,
        plan.cta_rows, *plan.grid, runtime.stream_ptr(x))
    runtime.check(err, name)
    runtime.note_launch(name, workers=C)
    return packed, scales, res


def _pack_outputs(x, bits):
    """Empty (packed, scales) for (C, rows, 128) f32 x at `bits`."""
    C, rows, _ = x.shape
    packed = (x.new_empty((C, rows, LANES), dtype=torch.int8) if bits == 8
              else x.new_empty((C, rows // 2, LANES), dtype=torch.uint8))
    return packed, x.new_empty((C, rows // BLOCK_ROWS), dtype=torch.float32)


def _fake_pack(x, bits, name):
    """The kernel's shape rule: the launch's checks, then the outputs."""
    _pack_plan(x, bits, name)
    return _pack_outputs(x, bits)


def _pack_cost(x, residual, seeds, bits):
    """quant_pack(_ef)'s operations (23 an element, 25 with error
    feedback) and bytes: x (and the residual in and out), the seeds, the
    payload and the scales."""
    n = x.numel()
    C, rows = x.shape[0], x.shape[1]
    out = n // (8 // bits) + 4 * C * (rows // BLOCK_ROWS)
    if residual is None:
        return 23 * n, 4 * n + 4 * C + out
    return 25 * n, 12 * n + 4 * C + out


def packed_rows(packed, bits, what: str) -> int:
    """The output rows of a (C, rows[/2], 128) payload at `bits`: the
    decoding launches' and their shape rules' check."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    _, prow, lanes = packed.shape
    rows = prow * (2 if bits == 4 else 1)
    if lanes != LANES or rows % BLOCK_ROWS:
        raise ValueError(f"{what}: bad packed shape {tuple(packed.shape)}")
    return rows


def _dequant_cuda(packed, scales, bits):
    runtime.require_cuda(packed)
    rows = packed_rows(packed, bits, "dequant_unpack")
    C, prow, _ = packed.shape
    plan = _dequant_plan(C, rows, bits)
    dev = packed.device
    runtime.require(packed, torch.int8 if bits == 8 else torch.uint8,
                    (C, prow, LANES), "dequant_unpack packed", dev)
    runtime.require(scales, torch.float32, (C, rows // BLOCK_ROWS),
                    "dequant_unpack scales", dev)
    if packed.data_ptr() % 16:
        raise ValueError("dequant_unpack packed: not 16-byte aligned")
    out = torch.empty((C, rows, LANES), dtype=torch.float32, device=dev)
    err = _lib().qp_dequant_unpack(packed.data_ptr(), scales.data_ptr(),
                                   out.data_ptr(), C, rows, bits,
                                   plan.threads, plan.parts, *plan.grid,
                                   runtime.stream_ptr(packed))
    runtime.check(err, "dequant_unpack")
    runtime.note_launch("dequant_unpack", workers=C)
    return out


def _dequant_fake(packed, scales, bits):
    rows = packed_rows(packed, bits, "dequant_unpack")
    _dequant_plan(packed.shape[0], rows, bits)
    return packed.new_empty((packed.shape[0], rows, LANES),
                            dtype=torch.float32)


def _dequant_cost(packed, scales, bits):
    """2 operations an output element; the payload and scales in, the
    f32 output."""
    n = packed.numel() * (8 // bits)
    return 2 * n, runtime.nbytes(packed) + runtime.nbytes(scales) + 4 * n


QUANT_PACK = runtime.register_op(
    "quant_pack", "(Tensor x, Tensor seeds, int bits) -> (Tensor, Tensor)",
    cuda=lambda x, seeds, bits: _launch_quant_pack(
        x, None, seeds, bits, "quant_pack")[:2],
    cpu=lambda x, seeds, bits: quant_pack_ref(x, seeds, bits=bits),
    fake=lambda x, seeds, bits: _fake_pack(x, bits, "quant_pack"),
    cost=lambda x, seeds, bits: _pack_cost(x, None, seeds, bits))
QUANT_PACK_EF = runtime.register_op(
    "quant_pack_ef",
    "(Tensor x, Tensor residual, Tensor seeds, int bits) "
    "-> (Tensor, Tensor, Tensor)",
    cuda=lambda x, residual, seeds, bits: _launch_quant_pack(
        x, residual, seeds, bits, "quant_pack_ef"),
    cpu=lambda x, residual, seeds, bits: quant_pack_ef_ref(
        x, residual, seeds, bits=bits),
    fake=lambda x, residual, seeds, bits: (
        *_fake_pack(x, bits, "quant_pack_ef"), torch.empty_like(x)),
    cost=_pack_cost)
DEQUANT_UNPACK = runtime.register_op(
    "dequant_unpack", "(Tensor packed, Tensor scales, int bits) -> Tensor",
    cuda=_dequant_cuda,
    cpu=lambda packed, scales, bits: dequant_unpack_ref(packed, scales,
                                                        bits=bits),
    fake=_dequant_fake, cost=_dequant_cost)


def quant_pack_2d(x: torch.Tensor, seeds: torch.Tensor, *, bits: int = 8
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize + pack on (C, rows, 128) f32 with (C,) int32 seeds.
    Returns packed (C, rows, 128) int8 / (C, rows/2, 128) uint8 and
    scales (C, rows/256) f32."""
    runtime.note_dispatch("quant_pack", x.device.type == "cpu", bits=bits)
    if runtime.direct(x):
        return _launch_quant_pack(x, None, seeds, bits, "quant_pack")[:2]
    return QUANT_PACK(x, seeds, bits)


def quant_pack_ef_2d(x: torch.Tensor, residual: torch.Tensor,
                     seeds: torch.Tensor, *, bits: int = 8
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused uplink pass on (C, rows, 128): quantize + pack x + residual
    and return the new error-feedback residual in the same pass."""
    runtime.note_dispatch("quant_pack_ef", x.device.type == "cpu",
                          bits=bits)
    if runtime.direct(x):
        return _launch_quant_pack(x, residual, seeds, bits, "quant_pack_ef")
    return QUANT_PACK_EF(x, residual, seeds, bits)


def dequant_unpack_2d(packed: torch.Tensor, scales: torch.Tensor, *,
                      bits: int = 8) -> torch.Tensor:
    """Decode packed (C, rows[/2], 128) + scales (C, nb) -> (C, rows,
    128) f32."""
    runtime.note_dispatch("dequant_unpack", packed.device.type == "cpu",
                          bits=bits)
    if runtime.direct(packed):
        return _dequant_cuda(packed, scales, bits)
    return DEQUANT_UNPACK(packed, scales, bits)


# ---------------------------------------------------------------------------
# leaf-level functions (any leaf shape, leading worker dim)
# ---------------------------------------------------------------------------

def _pad_2d(x: torch.Tensor) -> torch.Tensor:
    """(C, *leaf) -> (C, rows, 128) f32, each worker's flattened leaf
    zero-padded to whole (256, 128) blocks (the wire spec's per-leaf
    padding)."""
    C = x.shape[0]
    flat = x.reshape(C, -1).to(torch.float32)
    n = flat.shape[1]
    chunk = BLOCK_ROWS * LANES
    padded = -(-n // chunk) * chunk
    return torch.nn.functional.pad(flat, (0, padded - n)).reshape(
        C, -1, LANES)


def _unpad(x2: torch.Tensor, shape: tuple) -> torch.Tensor:
    C = x2.shape[0]
    n = 1
    for s in shape:
        n *= s
    return x2.reshape(C, -1)[:, :n].reshape((C,) + tuple(shape))


def quantize_pack(x: torch.Tensor, seeds: torch.Tensor, *, bits: int = 8
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack stacked (C, *leaf) f32 into the b-bit wire format. DTensor
    inputs run on each rank's workers (`sharding.boundary.per_worker`),
    as the three below."""
    if is_dtensor(x) or is_dtensor(seeds):
        return boundary.per_worker("quant_pack", quantize_pack, (x, seeds),
                                   2, bits=bits)
    return quant_pack_2d(_pad_2d(x), seeds, bits=bits)


def quantize_pack_ef(x: torch.Tensor, residual: torch.Tensor,
                     seeds: torch.Tensor, *, bits: int = 8
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused uplink hot path on a stacked leaf: returns (packed, scales,
    new_residual) with new_residual = (x + residual) - dequant(packed)
    shaped like x."""
    if is_dtensor(x) or is_dtensor(residual) or is_dtensor(seeds):
        return boundary.per_worker("quant_pack_ef", quantize_pack_ef,
                                   (x, residual, seeds), 3, bits=bits)
    packed, scales, res2 = quant_pack_ef_2d(_pad_2d(x), _pad_2d(residual),
                                            seeds, bits=bits)
    return packed, scales, _unpad(res2, tuple(x.shape[1:]))


def dequantize_unpack(packed: torch.Tensor, scales: torch.Tensor,
                      shape: tuple, *, bits: int = 8,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decode stacked payloads back to (C, *shape)."""
    if is_dtensor(packed) or is_dtensor(scales):
        return boundary.per_worker("dequant_unpack", dequantize_unpack,
                                   (packed, scales), 1, shape=shape,
                                   bits=bits, dtype=dtype)
    x2 = dequant_unpack_2d(packed, scales, bits=bits)
    return _unpad(x2, tuple(shape)).to(dtype)


def quant_dequant(x: torch.Tensor, seeds: torch.Tensor, *, bits: int = 8
                  ) -> torch.Tensor:
    """What the receiver decodes: quantize-pack then unpack (the dense
    route's simulation of the wire)."""
    if is_dtensor(x) or is_dtensor(seeds):
        return boundary.per_worker("quant_pack", quant_dequant, (x, seeds),
                                   1, bits=bits)
    packed, scales = quantize_pack(x, seeds, bits=bits)
    return dequantize_unpack(packed, scales, tuple(x.shape[1:]), bits=bits,
                             dtype=x.dtype)
