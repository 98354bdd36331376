"""Plain PyTorch versions of the quantize-pack kernel family — the wire
spec written out op by op, on stacked workers.

Layout: a worker's flattened leaf is tiled to (rows, 128) with rows a
multiple of BLOCK_ROWS; the stacked form is (C, rows, 128). Each
(BLOCK_ROWS, 128) block gets one f32 scale; int8 packs 1:1, int4 packs
row r of a block into the low nibble and row r + 128 into the high
nibble of output row r (biased by +8). Stochastic rounding uses the
integer hash `block_uniform` of (seed, block, row, lane), where `block`
is the block's index within that worker's leaf.

These run the CPU tests and are what `chip_smoke.py` holds each CUDA
kernel (csrc/quant_pack.cu) against on the card. They match the JAX
refs (repro/kernels/quant_pack/ref.py) bit for bit in payload and
scales; the residual matches the fused multiply-subtract to within
double rounding (computed in f64, rounded once).
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 256
LANES = 128
QMAX = {8: 127.0, 4: 7.0}
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for h in [0, 2^32) held in int64, without any
    intermediate above 2^49 (a plain int64 product could overflow)."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def block_uniform(seed: torch.Tensor, block_idx: int,
                  shape: tuple[int, int] = (BLOCK_ROWS, LANES)
                  ) -> torch.Tensor:
    """U[0,1) field of one block per worker: seed (C,) int -> (C, *shape)
    f32. The splitmix-style uint32 hash of the wire spec, in int64 with
    the low 32 bits kept after every multiply."""
    dev = seed.device
    s = seed.to(torch.int64).reshape(-1, 1, 1) & _M32
    r = torch.arange(shape[0], dtype=torch.int64, device=dev).reshape(1, -1, 1)
    c = torch.arange(shape[1], dtype=torch.int64, device=dev).reshape(1, 1, -1)
    h = (_mul32(s, 2654435761) + ((block_idx * 976686449) & _M32)
         + _mul32(r, 1664525) + _mul32(c, 22695477)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _quantize_block(acc: torch.Tensor, seed: torch.Tensor, block_idx: int,
                    qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """acc (C, B, 128) f32 -> (q f32 in [-qmax, qmax], scale (C,) f32).
    scale = amax * f32(1/qmax) (the reciprocal form is part of the
    spec), 1 for an all-zero block; q = clip(floor(acc/scale + u))."""
    amax = acc.abs().amax(dim=(1, 2))
    inv = torch.tensor(np.float32(1.0 / qmax), device=acc.device)
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    u = block_uniform(seed, block_idx, tuple(acc.shape[1:]))
    q = torch.floor(acc / scale[:, None, None] + u).clamp(-qmax, qmax)
    return q, scale


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """(..., B, 128) integral f32 in [-7, 7] -> (..., B/2, 128) uint8:
    output row r holds rows r (low nibble) and r + B/2 (high nibble)."""
    half = q.shape[-2] // 2
    biased = (q + 8.0).to(torch.int32)
    return (biased[..., :half, :] | (biased[..., half:, :] << 4)).to(
        torch.uint8)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of _pack_nibbles: (..., B/2, 128) uint8 -> (..., B, 128)
    f32 in [-7, 7]."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) - 8).to(torch.float32)
    hi = ((p >> 4) - 8).to(torch.float32)
    return torch.cat([lo, hi], dim=-2)


def _quant_pack(x: torch.Tensor, residual, seeds: torch.Tensor, bits: int):
    C, rows, lanes = x.shape
    assert lanes == LANES and rows % BLOCK_ROWS == 0, x.shape
    qmax = QMAX[bits]
    qs, scales, ress = [], [], []
    for b in range(rows // BLOCK_ROWS):          # per-block loop
        sl = slice(b * BLOCK_ROWS, (b + 1) * BLOCK_ROWS)
        acc = x[:, sl] if residual is None else x[:, sl] + residual[:, sl]
        q, scale = _quantize_block(acc, seeds, b, qmax)
        qs.append(q.to(torch.int8) if bits == 8 else _pack_nibbles(q))
        scales.append(scale)
        if residual is not None:
            # acc - q*scale rounded once, as the kernel's fmaf does (the
            # f64 product of a small integer and an f32 is exact)
            ress.append((acc.double() - q.double() * scale.double()[
                :, None, None]).float())
    packed = torch.cat(qs, dim=1)
    scales = torch.stack(scales, dim=1)
    if residual is None:
        return packed, scales
    return packed, scales, torch.cat(ress, dim=1)


def quant_pack_ref(x: torch.Tensor, seeds: torch.Tensor, *, bits: int = 8
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (C, rows, 128) f32, seeds (C,) int32 -> packed (C, rows, 128)
    int8 or (C, rows/2, 128) uint8, scales (C, rows/256) f32."""
    return _quant_pack(x, None, seeds, bits)


def quant_pack_ef_ref(x: torch.Tensor, residual: torch.Tensor,
                      seeds: torch.Tensor, *, bits: int = 8
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused uplink pass: acc = x + residual, quantize and pack acc, new
    residual = acc - q*scale. Returns (packed, scales, new_residual)."""
    assert x.shape == residual.shape, (x.shape, residual.shape)
    return _quant_pack(x, residual, seeds, bits)


def dequant_unpack_ref(packed: torch.Tensor, scales: torch.Tensor, *,
                       bits: int = 8) -> torch.Tensor:
    """packed (C, rows[/2], 128) + scales (C, nb) -> (C, rows, 128) f32."""
    C, prow, lanes = packed.shape
    if bits == 8:
        q = packed.to(torch.float32)
    else:
        q = _unpack_nibbles(packed.reshape(C, -1, BLOCK_ROWS // 2, lanes))
    nb = scales.shape[1]
    qb = q.reshape(C, nb, BLOCK_ROWS, lanes)
    return (qb * scales[:, :, None, None]).reshape(C, nb * BLOCK_ROWS, lanes)
