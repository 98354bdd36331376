"""The wire of the paper engine, in plain PyTorch: block-scaled
stochastic quantization to int8 or int4 with error feedback, the Eq.-7
masked mean and the quantized downlink with the PS's own error feedback.

The quantizer is the wire format's specification, a frozen copy of the
port's plain arithmetic (kernels/quant_pack/ref.py): a worker's leaf is
flattened, zero-padded to whole (256, 128) blocks and tiled (rows, 128);
each block gets one f32 scale amax * f32(1 / qmax) (1 for an all-zero
block) and q = clip(floor(x / scale + u), -qmax, qmax) with u the uint32
hash `block_uniform` of (seed, block, row, lane). The receiver decodes
q * scale. Leaf l of worker c rounds with seed[c, l], leaves in sorted
key order."""
from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 256
LANES = 128
QMAX = {8: 127.0, 4: 7.0}
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for h in [0, 2^32) held in int64."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def block_uniform(seed: torch.Tensor, block: int) -> torch.Tensor:
    """U[0, 1) field (C, 256, 128) of block `block` for seeds (C,)."""
    dev = seed.device
    s = seed.to(torch.int64).reshape(-1, 1, 1) & _M32
    r = torch.arange(BLOCK_ROWS, dtype=torch.int64, device=dev)[None, :, None]
    c = torch.arange(LANES, dtype=torch.int64, device=dev)[None, None, :]
    h = (_mul32(s, 2654435761) + ((block * 976686449) & _M32)
         + _mul32(r, 1664525) + _mul32(c, 22695477)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quant_dequant(x: torch.Tensor, seed: torch.Tensor, bits: int
                  ) -> torch.Tensor:
    """What the receiver decodes of the stacked leaf x (C, *leaf) f32."""
    C = x.shape[0]
    flat = x.reshape(C, -1)
    n = flat.shape[1]
    chunk = BLOCK_ROWS * LANES
    padded = torch.nn.functional.pad(flat, (0, -(-n // chunk) * chunk - n))
    tiles = padded.reshape(C, -1, BLOCK_ROWS, LANES)
    qmax = QMAX[bits]
    inv = torch.tensor(np.float32(1.0 / qmax), device=x.device)
    out = torch.empty_like(tiles)
    for b in range(tiles.shape[1]):
        acc = tiles[:, b]
        amax = acc.abs().amax(dim=(1, 2))
        scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
        q = torch.floor(acc / scale[:, None, None]
                        + block_uniform(seed, b)).clamp(-qmax, qmax)
        out[:, b] = q * scale[:, None, None]
    return out.reshape(C, -1)[:, :n].reshape(x.shape)


def uplink(deltas: list, residual: list, mask: torch.Tensor,
           seeds: torch.Tensor, bits: int) -> tuple[list, list]:
    """Each worker sends delta + residual quantized; its residual becomes
    what the wire dropped, for the selected workers only (the others keep
    theirs). Returns (decoded, new residual), leaf lists."""
    sent, kept = [], []
    sel = mask > 0
    for i, (d, r) in enumerate(zip(deltas, residual)):
        acc = d + r
        q = quant_dequant(acc, seeds[:, i].contiguous(), bits)
        sent.append(q)
        kept.append(torch.where(sel.reshape((-1,) + (1,) * (d.ndim - 1)),
                                acc - q, r))
    return sent, kept


def aggregate(global_leaves: list, decoded: list,
              mask: torch.Tensor) -> list:
    """Eq. 7: w_t plus the masked mean of the delivered decoded deltas."""
    denom = torch.clamp(mask.sum(), min=1.0)
    m = mask.to(torch.float32)
    return [g + (m.reshape((-1,) + (1,) * (g.ndim)) * d).sum(0) / denom
            for g, d in zip(global_leaves, decoded)]


def downlink(new_leaves: list, prev_leaves: list, ps_residual: list,
             seeds: torch.Tensor, bits: int) -> tuple[list, list]:
    """The PS broadcasts the global delta quantized with its own error
    feedback; the workers decode w_t + the decoded delta. seeds (L,)."""
    out, res = [], []
    for i, (a, g, r) in enumerate(zip(new_leaves, prev_leaves, ps_residual)):
        acc = (a - g)[None] + r[None]
        q = quant_dequant(acc, seeds[i:i + 1].contiguous(), bits)
        out.append(g + q[0])
        res.append((acc - q)[0])
    return out, res
