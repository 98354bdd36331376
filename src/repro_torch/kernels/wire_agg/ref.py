"""Plain PyTorch version of the fused dequant + masked-aggregate kernel
(csrc/wire_agg.cu): C stacked packed payloads -> the Eq.-7 aggregate.

Same arithmetic as the CUDA kernel, written op by op: the mean and the
trimmed mean sum in worker (resp. sorted) order, one IEEE add at a time,
so the kernel can be held to it exactly; the robust modes sort with
`torch.sort`. Against the JAX ref (repro/kernels/wire_agg/ref.py) the
median is bitwise and the sums agree up to summation order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.quant_pack.ref import dequant_unpack_ref

AGGREGATORS = ("mean", "median", "trimmed_mean")
# internal mode: the masked weighted partial SUM, no divide
TREE_MODES = AGGREGATORS + ("sum",)


def wire_agg_ref(packed: torch.Tensor, scales: torch.Tensor,
                 mask: torch.Tensor, weights: torch.Tensor, *, bits: int = 8,
                 aggregator: str = "mean", trim_ratio: float = 0.1
                 ) -> torch.Tensor:
    """packed (C, rows[/2], 128), scales (C, nb), mask/weights (C,) f32
    -> (rows, 128) f32 aggregate delta."""
    assert aggregator in TREE_MODES, aggregator
    C = packed.shape[0]
    d = dequant_unpack_ref(packed, scales, bits=bits)       # (C, rows, 128)
    mask = mask.reshape(C)
    weights = weights.reshape(C)

    if aggregator in ("mean", "sum"):
        mw = mask * weights
        s = torch.zeros_like(d[0])
        total = torch.zeros((), dtype=torch.float32, device=d.device)
        for c in range(C):                      # worker order
            s = s + mw[c] * d[c]
            total = total + mw[c]
        if aggregator == "sum":
            return s
        return s / torch.clamp(total, min=1.0)

    k = int(mask.sum().item())
    if k <= 0:                                  # all-lost round
        return torch.zeros_like(d[0])
    vals = torch.where(mask.reshape(C, 1, 1) > 0, d * weights.reshape(C, 1, 1),
                       torch.full_like(d, float("inf")))
    svals = torch.sort(vals, dim=0).values
    if aggregator == "median":
        lo = (k - 1) // 2
        hi = (k - 1) - lo
        return 0.5 * (svals[lo] + svals[hi])
    t = int(np.float32(trim_ratio) * np.float32(k))
    t = min(t, (k - 1) // 2)
    s = torch.zeros_like(d[0])
    for c in range(t, k - t):                   # sorted order
        s = s + svals[c]
    # divide by a device tensor: a Python-float divisor takes PyTorch's
    # reciprocal-multiply shortcut on CUDA, 1 ulp off IEEE division
    return s / torch.tensor(float(max(k - 2 * t, 1)), device=s.device)
