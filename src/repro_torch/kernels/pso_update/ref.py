"""Plain PyTorch version of the fused PSO update (paper Eq. 8) over a
stacked (W, ...) leaf, with per-worker coefficients. The oracle of
csrc/pso_update.cu, which repeats its arithmetic op for op.

It follows the rounding points of the JAX package's inline leaf
(`repro/core/swarm_dist.py` local_round): for a bf16 leaf, wl - w,
wg - w and d are bf16 values; the velocity sum is formed in f32, left
to right; the clip is applied in f32; v' is rounded to the leaf dtype
and w' = dtype(f32(w) + f32(v')). For an f32 leaf every cast is a no-op
and this is the JAX package's `pso_update_ref`."""
from __future__ import annotations

import torch


def pso_update_ref(coefs: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                   wl: torch.Tensor, wg: torch.Tensor, d: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """coefs (W, 4) f32 rows (c0, c1, c2, clip), clip <= 0 = no clip;
    w, v, wl, d (W, *leaf) and wg (*leaf) of one dtype. Returns
    (w', v') in the leaf dtype."""
    f32 = torch.float32
    c = coefs.to(f32).reshape((coefs.shape[0], 4) + (1,) * (w.ndim - 1))
    c0, c1, c2, clip = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    wf = w.to(f32)
    v_new = c0 * v.to(f32)
    v_new = v_new + c1 * (wl - w).to(f32)
    v_new = v_new + c2 * (wg.unsqueeze(0) - w).to(f32)
    v_new = v_new + d.to(f32)
    v_new = torch.where(clip > 0, torch.clamp(v_new, -clip, clip), v_new)
    v_out = v_new.to(w.dtype)
    return (wf + v_out.to(f32)).to(w.dtype), v_out
