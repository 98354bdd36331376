"""The dry-run's roofline and collective summary (the JAX package's
`launch/hlo_analysis.py`), on one NVIDIA H100's constants.

`roofline(...)` combines the cost model's per-rank FLOPs, HBM bytes and
collective bytes (`launch/op_costmodel.py`) into the three-term model:
every term is seconds per step per card, the cards acting in parallel.
The constants are `launch/mesh.py`'s: 989 TFLOP/s bf16 dense, 3.35 TB/s
of HBM, 450 GB/s of NVLink each way.

One collective term at one link rate, as the reference's one `ICI_BW`:
an H100 host joins 8 cards all to all by NVLink, so a 16-wide "model"
axis (the (16, 16) production mesh) spans two hosts and its collectives
would run partly over the slower network between them; the single term
at `NVLINK_BW` is a lower bound on that time. The collective summary
keeps the reference's keys (`by_kind_bytes`, `by_kind_count`,
`total_bytes`; `op_costmodel.OpCostModel.collectives`).
"""
from __future__ import annotations

from typing import Any

from repro_torch.launch import mesh as hw


def roofline(flops: float, hbm_bytes: float, coll_bytes: float,
             model_flops_per_device: float,
             fma_counted: bool = True) -> dict[str, Any]:
    """Three-term roofline (seconds, per-card program).

    With `fma_counted=True` (a count of one per fused multiply-add) the
    compute term doubles the count; the cost model counts 2 N M K true
    flops for a product, so it passes `fma_counted=False`.
    `useful_flops_ratio` = MODEL_FLOPS / true FLOPs: 1.0 means every
    counted flop is a model flop; < 1 flags recompute (remat) and
    redundancy; > 1 flags compute the analytic 6ND model misses
    (attention scores, recurrent gates)."""
    eff_flops = 2.0 * flops if fma_counted else float(flops)
    t_compute = eff_flops / hw.PEAK_FLOPS_BF16
    t_memory = hbm_bytes / hw.HBM_BW
    t_coll = coll_bytes / hw.NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    useful = (model_flops_per_device / eff_flops) if flops else 0.0
    return {**terms, "dominant": dominant,
            "model_flops_per_device": model_flops_per_device,
            "useful_flops_ratio": useful,
            "bound_step_s": max(terms.values())}
