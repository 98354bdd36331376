"""Wrappers for the quantize-pack kernel family: the CUDA launchers
(csrc/quant_pack.cu, bound through ctypes) and the leaf-level functions
that flatten a stacked (C, *leaf) array to the kernels' (C, rows, 128)
layout, pad it to whole (256, 128) blocks, and undo that on the way out.

Every function takes a leading worker dimension C: the kernels run all
workers of a leaf in one launch (grid over block x worker), where the
JAX package vmaps a per-worker call. The downlink passes C = 1.

Dispatch is by the device of the input: CPU tensors take the plain
versions in ref.py, CUDA tensors launch the kernel (or raise).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.quant_pack.ref import (BLOCK_ROWS, LANES,
                                                dequant_unpack_ref,
                                                quant_pack_ef_ref,
                                                quant_pack_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = runtime.library("quant_pack")
    if lib.qp_quant_pack.argtypes is None:
        lib.qp_quant_pack.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.qp_quant_pack.restype = _I
        lib.qp_dequant_unpack.argtypes = [_P, _P, _P, ctypes.c_longlong, _I,
                                          _P]
        lib.qp_dequant_unpack.restype = _I
    return lib


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def _launch_quant_pack(x, residual, seeds, bits, name):
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    C, rows, lanes = x.shape
    if lanes != LANES or rows % BLOCK_ROWS:
        raise ValueError(f"{name}: x must be (C, rows, 128) with rows % "
                         f"{BLOCK_ROWS} == 0, got {tuple(x.shape)}")
    dev = x.device
    runtime.require(x, torch.float32, (C, rows, LANES), f"{name} x", dev)
    if residual is not None:
        runtime.require(residual, torch.float32, (C, rows, LANES),
                        f"{name} residual", dev)
    runtime.require(seeds, torch.int32, (C,), f"{name} seeds", dev)
    nb = rows // BLOCK_ROWS
    if bits == 8:
        packed = torch.empty((C, rows, LANES), dtype=torch.int8, device=dev)
    else:
        packed = torch.empty((C, rows // 2, LANES), dtype=torch.uint8,
                             device=dev)
    scales = torch.empty((C, nb), dtype=torch.float32, device=dev)
    res = (None if residual is None
           else torch.empty((C, rows, LANES), dtype=torch.float32, device=dev))
    err = _lib().qp_quant_pack(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        seeds.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        None if res is None else res.data_ptr(), C, rows, bits,
        runtime.stream_ptr(x))
    runtime.check(err, name)
    runtime.note_launch(name)
    return packed, scales, res


def quant_pack_2d(x: torch.Tensor, seeds: torch.Tensor, *, bits: int = 8
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize + pack on (C, rows, 128) f32 with (C,) int32 seeds.
    Returns packed (C, rows, 128) int8 / (C, rows/2, 128) uint8 and
    scales (C, rows/256) f32."""
    if _is_cpu(x):
        return quant_pack_ref(x, seeds, bits=bits)
    packed, scales, _ = _launch_quant_pack(x, None, seeds, bits,
                                           "quant_pack")
    return packed, scales


def quant_pack_ef_2d(x: torch.Tensor, residual: torch.Tensor,
                     seeds: torch.Tensor, *, bits: int = 8
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused uplink pass on (C, rows, 128): quantize + pack x + residual
    and return the new error-feedback residual in the same pass."""
    if _is_cpu(x):
        return quant_pack_ef_ref(x, residual, seeds, bits=bits)
    return _launch_quant_pack(x, residual, seeds, bits, "quant_pack_ef")


def dequant_unpack_2d(packed: torch.Tensor, scales: torch.Tensor, *,
                      bits: int = 8) -> torch.Tensor:
    """Decode packed (C, rows[/2], 128) + scales (C, nb) -> (C, rows,
    128) f32."""
    if _is_cpu(packed):
        return dequant_unpack_ref(packed, scales, bits=bits)
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    C, prow, lanes = packed.shape
    rows = prow * (2 if bits == 4 else 1)
    if lanes != LANES or rows % BLOCK_ROWS:
        raise ValueError(f"dequant_unpack: bad packed shape "
                         f"{tuple(packed.shape)}")
    dev = packed.device
    runtime.require(packed, torch.int8 if bits == 8 else torch.uint8,
                    (C, prow, LANES), "dequant_unpack packed", dev)
    runtime.require(scales, torch.float32, (C, rows // BLOCK_ROWS),
                    "dequant_unpack scales", dev)
    out = torch.empty((C, rows, LANES), dtype=torch.float32, device=dev)
    err = _lib().qp_dequant_unpack(packed.data_ptr(), scales.data_ptr(),
                                   out.data_ptr(), C * (rows // BLOCK_ROWS),
                                   bits, runtime.stream_ptr(packed))
    runtime.check(err, "dequant_unpack")
    runtime.note_launch("dequant_unpack")
    return out


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
    """Pack stacked (C, *leaf) f32 into the b-bit wire format."""
    return quant_pack_2d(_pad_2d(x), seeds, bits=bits)


def quantize_pack_ef(x: torch.Tensor, residual: torch.Tensor,
                     seeds: torch.Tensor, *, bits: int = 8
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused uplink hot path on a stacked leaf: returns (packed, scales,
    new_residual) with new_residual = (x + residual) - dequant(packed)
    shaped like x."""
    packed, scales, res2 = quant_pack_ef_2d(_pad_2d(x), _pad_2d(residual),
                                            seeds, bits=bits)
    return packed, scales, _unpad(res2, tuple(x.shape[1:]))


def dequantize_unpack(packed: torch.Tensor, scales: torch.Tensor,
                      shape: tuple, *, bits: int = 8,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decode stacked payloads back to (C, *shape)."""
    x2 = dequant_unpack_2d(packed, scales, bits=bits)
    return _unpad(x2, tuple(shape)).to(dtype)


def quant_dequant(x: torch.Tensor, seeds: torch.Tensor, *, bits: int = 8
                  ) -> torch.Tensor:
    """What the receiver decodes: quantize-pack then unpack (the dense
    route's simulation of the wire)."""
    packed, scales = quantize_pack(x, seeds, bits=bits)
    return dequantize_unpack(packed, scales, tuple(x.shape[1:]), bits=bits,
                             dtype=x.dtype)
