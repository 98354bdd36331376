"""Recurrent temporal-mixing blocks of the port, as the JAX package's
`models/recurrent.py`: RG-LRU (RecurrentGemma, arXiv:2402.19427) and
xLSTM's mLSTM and sLSTM (arXiv:2405.04517).

    x -> norm -> { branch_y = gelu(W_y x) ; branch_x = conv1d_4(W_x x) ->
      RG-LRU } -> W_o (branch_y * lru_out)
    RG-LRU: r_t = sigmoid(W_r u + b_r); i_t = sigmoid(W_i u + b_i)
            a_t = exp(c * softplus(Lambda) * (-r_t))        (c = 8)
            h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

A multi-step RG-LRU call (train, prefill) runs the diagonal recurrence
through `kernels.rglru_scan` with h0 passed in, where the reference
folds h0 into b[:, 0] and runs `jax.lax.associative_scan`: the same
function (differentiable through the scan's backward kernel). A
one-token decode takes a single elementwise step.

The xLSTM blocks are plain PyTorch, as the reference has no kernel for
them: `lax.scan` becomes a Python loop, over chunks of 256 (mLSTM, a
masked quadratic form within a chunk and a (C, n, m) carry across) or
over time (sLSTM, whose recurrent weights act on h_{t-1}). Param and
cache trees are the reference's. Points where the two frameworks could
part:
  * ties: `A.max(axis=2)` is `torch.amax` and `jnp.maximum` is
    `torch.maximum`, which split the gradient evenly among ties as JAX
    does (`Tensor.max(dim)` would send it all to one index);
  * the sLSTM's normaliser n starts at ones, not zeros (state and cache);
  * `b_if` and the sLSTM's `b` stay f32 in a bf16 model, and `w_rec` is
    drawn with fan-in hd;
  * bf16 rounding: k is divided by sqrt(hd) rounded to the working dtype,
    in that dtype, before the f32 cast; hs is cast back to x's dtype
    before `out_norm`;
  * S == 1 takes `mlstm_sequential` whatever the mode, S > 1
    `mlstm_chunked`;
  * the sLSTM's recurrent product runs in f32 (full f32 on a card: the
    entry points turn TF32 off).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.sharding.rules import shard
from repro_torch.models.layers import (F32, cdtype, dense_init, rmsnorm,
                                       rmsnorm_init)

PyTree = Any

_RGLRU_C = 8.0
_CONV_W = 4


def rglru_init(gen, cfg, device, lead: tuple = ()) -> PyTree:
    d = cfg.d_model
    dt = cdtype(cfg)
    lead = tuple(lead)
    # Lambda init so a^c spans (0.9, 0.999) like the paper
    lam = 0.9 + (0.999 - 0.9) * torch.rand(lead + (d,), generator=gen,
                                           device=device, dtype=F32)
    lam_param = torch.log(torch.exp(-torch.log(lam) / _RGLRU_C) - 1.0)
    return {
        "norm": rmsnorm_init(d, device, lead),
        "wx": dense_init(gen, (d, d), d, dt, device, lead),
        "wy": dense_init(gen, (d, d), d, dt, device, lead),
        "wo": dense_init(gen, (d, d), d, dt, device, lead),
        "conv": dense_init(gen, (_CONV_W, d), _CONV_W, dt, device, lead)
        / math.sqrt(_CONV_W),
        "w_r": dense_init(gen, (d, d), d, dt, device, lead),
        "w_i": dense_init(gen, (d, d), d, dt, device, lead),
        "b_r": torch.zeros(lead + (d,), dtype=dt, device=device),
        "b_i": torch.zeros(lead + (d,), dtype=dt, device=device),
        "lam": lam_param,
    }


def _causal_conv(w: torch.Tensor, x: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width 4, in x's dtype. x: (B,S,D); state:
    (B, W-1, D). Returns (out, new state)."""
    B, S, D = x.shape
    if state is None:
        state = torch.zeros((B, _CONV_W - 1, D), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, _CONV_W):
        out = out + xp[:, i:i + S] * w[i]
    # a copy: the cache must not keep the whole (B, S+3, D) input alive
    return out, xp[:, -(_CONV_W - 1):].clone()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) with no linear cut-over (jax.nn.softplus)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_gates(params: PyTree, u: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_a, beta*i*u) in f32. u: (B,S,D)."""
    r = torch.sigmoid(torch.matmul(u, params["w_r"]).to(F32)
                      + params["b_r"].to(F32))
    i = torch.sigmoid(torch.matmul(u, params["w_i"]).to(F32)
                      + params["b_i"].to(F32))
    log_a = -_RGLRU_C * _softplus(params["lam"]) * r       # (B,S,D) f32
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    return log_a, beta * i * u.to(F32)


def rglru_apply(params: PyTree, x: torch.Tensor, cfg, *, mode: str,
                layer_cache: Optional[PyTree] = None
                ) -> tuple[torch.Tensor, Optional[PyTree]]:
    B, S, D = x.shape
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    y_branch = F.gelu(torch.matmul(h, params["wy"]), approximate="tanh")
    u = torch.matmul(h, params["wx"])
    conv_state = None if layer_cache is None else layer_cache["conv"]
    u, new_conv = _causal_conv(params["conv"], u, conv_state)
    log_a, b = _rglru_gates(params, u)

    h0 = (torch.zeros((B, D), dtype=F32, device=x.device)
          if layer_cache is None else layer_cache["h"])
    if mode == "decode" and S == 1:
        a = torch.exp(log_a[:, 0])
        h_new = a * h0 + b[:, 0]
        states = h_new[:, None]
    else:
        states, h_new = rglru_scan(h0, torch.exp(log_a), b)

    states = shard(states.to(x.dtype), ("batch", "seq", "embed"))
    out = shard(torch.matmul(y_branch * states, params["wo"]),
                ("batch", "seq", "embed"))
    cache = None
    if layer_cache is not None:
        cache = {"h": h_new, "conv": new_conv}
    return out, cache


def init_rglru_cache(cfg, batch: int, dtype, device, lead: tuple = ()
                     ) -> PyTree:
    d = cfg.d_model
    lead = tuple(lead)
    return {"h": torch.zeros(lead + (batch, d), dtype=F32, device=device),
            "conv": torch.zeros(lead + (batch, _CONV_W - 1, d), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM matrix memory)
# ---------------------------------------------------------------------------
# Recurrence per head (state C: (hd_v, hd_k), n: (hd_k,), m: ()):
#   f_t = sigmoid(f_raw);  i_t = exp(i_raw)    (log-space stabilized)
#   m_t = max(log f_t + m_{t-1}, log i_t)
#   C_t = exp(log f_t + m_{t-1} - m_t) C_{t-1} + exp(log i_t - m_t) v_t k_t^T
#   n_t = ... same ... + exp(log i_t - m_t) k_t
#   h_t = C_t q_t / max(|n_t . q_t|, exp(-m_t))
# Block: norm -> up-proj (expansion 2) -> q,k,v + gates -> recurrence ->
#        out-gate * norm(h) -> down-proj.

_MLSTM_EXP = 2


def _gate_bias(parts: tuple, lead: tuple, device) -> torch.Tensor:
    """An f32 bias of constant runs [(n, value), ...], repeated over
    `lead` (the reference concatenates, then vmaps over the group)."""
    b = torch.cat([torch.full((n,), v, dtype=F32, device=device)
                   for n, v in parts])
    return b.repeat(tuple(lead) + (1,))


def mlstm_init(gen, cfg, device, lead: tuple = ()) -> PyTree:
    d = cfg.d_model
    di = _MLSTM_EXP * d
    H = cfg.num_heads
    dt = cdtype(cfg)
    lead = tuple(lead)
    return {
        "norm": rmsnorm_init(d, device, lead),
        "w_up": dense_init(gen, (d, di), d, dt, device, lead),
        "w_gate": dense_init(gen, (d, di), d, dt, device, lead),
        "mq": dense_init(gen, (di, di), di, dt, device, lead),
        "mk": dense_init(gen, (di, di), di, dt, device, lead),
        "mv": dense_init(gen, (di, di), di, dt, device, lead),
        "w_if": dense_init(gen, (di, 2 * H), di, dt, device, lead),
        "b_if": _gate_bias(((H, 0.0), (H, 3.0)), lead, device),
        "out_norm": rmsnorm_init(di, device, lead),
        "w_down": dense_init(gen, (di, d), di, dt, device, lead),
    }


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """The Python float x rounded to `dtype` (how JAX applies a weakly
    typed scalar to an array of that dtype)."""
    return float(torch.tensor(x, dtype=dtype))


def _mlstm_qkvg(params, x, cfg):
    B, S, _ = x.shape
    H = cfg.num_heads
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    up = torch.matmul(h, params["w_up"])
    gate = F.silu(torch.matmul(h, params["w_gate"]))
    di = up.shape[-1]
    hd = di // H
    q = torch.matmul(up, params["mq"]).reshape(B, S, H, hd)
    k = torch.matmul(up, params["mk"]).reshape(B, S, H, hd)
    k = k / _in_dtype(math.sqrt(hd), k.dtype)
    v = torch.matmul(up, params["mv"]).reshape(B, S, H, hd)
    if_raw = (torch.matmul(up, params["w_if"]).to(F32)
              + params["b_if"].to(F32))
    log_i = if_raw[..., :H]                      # log input gate (pre-exp)
    log_f = F.logsigmoid(if_raw[..., H:])        # log sigmoid forget
    return q, k, v, gate, log_i, log_f


def mlstm_sequential(q, k, v, log_i, log_f, C0, n0, m0):
    """Exact per-step recurrence (decode). Shapes: q/k/v (B,S,H,hd);
    gates (B,S,H); states C (B,H,hd,hd), n (B,H,hd), m (B,H). Returns
    (h (B,S,H,hd), C, n, m), all f32."""
    q, k, v = q.to(F32), k.to(F32), v.to(F32)
    C, n, m = C0, n0, m0
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt = q[:, t], k[:, t], v[:, t]           # (B,H,hd)
        li, lf = log_i[:, t], log_f[:, t]                # (B,H)
        m_new = torch.maximum(lf + m, li)
        fa = torch.exp(lf + m - m_new)[..., None]
        ia = torch.exp(li - m_new)[..., None]
        C = fa[..., None] * C + ia[..., None] * (vt[..., None]
                                                 * kt[..., None, :])
        n = fa * n + ia * kt
        denom = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                              torch.exp(-m_new))
        hs.append(torch.einsum("bhvk,bhk->bhv", C, qt) / denom[..., None])
        m = m_new
    return torch.stack(hs, dim=1), C, n, m


def mlstm_chunked(q, k, v, log_i, log_f, C0, n0, m0, chunk: int = 256):
    """Chunk-parallel mLSTM (the reference's derivation): within a chunk
    a masked quadratic form, across chunks the (C, n, m) carry. Equals
    `mlstm_sequential` up to rounding. The sequence is padded to whole
    chunks with log_i = -1e30 (padded sources add nothing) and log_f = 0
    (the carry after the last chunk is the true final state)."""
    B, S, H, hd = q.shape
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    q, k, v = q.to(F32), k.to(F32), v.to(F32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    C, n, m = C0, n0, m0
    hs = []
    for j in range(nc):
        sl = slice(j * chunk, (j + 1) * chunk)
        qt, kt, vt = q[:, sl], k[:, sl], v[:, sl]        # (B,c,H,hd)
        li, lf = log_i[:, sl], log_f[:, sl]              # (B,c,H)
        Fc = torch.cumsum(lf, dim=1)                     # (B,c,H)
        carry_logw = Fc + m[:, None]                     # (B,c,H)
        A = li[:, None] + Fc[:, :, None] - Fc[:, None]   # (B,t,s,H)
        A = torch.where(tri, A, -math.inf)
        m_t = torch.maximum(carry_logw, torch.amax(A, dim=2))
        w_carry = torch.exp(carry_logw - m_t)            # (B,c,H)
        W = torch.exp(A - m_t[:, :, None])               # (B,t,s,H)
        W = torch.where(tri, W, 0.0)

        scores = torch.einsum("bthd,bshd->btsh", qt, kt) * W
        num = (torch.einsum("btsh,bshd->bthd", scores, vt)
               + w_carry[..., None] * torch.einsum("bhvk,bthk->bthv", C, qt))
        n_t = (torch.einsum("btsh,bshd->bthd", W, kt)
               + w_carry[..., None] * n[:, None])
        denom = torch.maximum(
            torch.abs(torch.einsum("bthd,bthd->bth", n_t, qt)),
            torch.exp(-m_t))
        hs.append(num / denom[..., None])

        wl = W[:, -1]                                    # (B,s,H)
        # sum_s wl v k^T as one product (a three-operand einsum could
        # form a (B, s, H, hd, hd) intermediate)
        C = (w_carry[:, -1][..., None, None] * C
             + torch.einsum("bshv,bshk->bhvk", wl[..., None] * vt, kt))
        n = w_carry[:, -1][..., None] * n + torch.einsum("bsh,bshk->bhk",
                                                         wl, kt)
        m = m_t[:, -1]
    return torch.cat(hs, dim=1)[:, :S], C, n, m


def mlstm_block_apply(params: PyTree, x: torch.Tensor, cfg, *, mode: str,
                      layer_cache: Optional[PyTree] = None
                      ) -> tuple[torch.Tensor, Optional[PyTree]]:
    B, S, D = x.shape
    H = cfg.num_heads
    q, k, v, gate, log_i, log_f = _mlstm_qkvg(params, x, cfg)
    hd = q.shape[-1]
    if layer_cache is None:
        C0 = torch.zeros((B, H, hd, hd), dtype=F32, device=x.device)
        n0 = torch.zeros((B, H, hd), dtype=F32, device=x.device)
        m0 = torch.zeros((B, H), dtype=F32, device=x.device)
    else:
        C0, n0, m0 = layer_cache["C"], layer_cache["n"], layer_cache["m"]
    run = mlstm_sequential if S == 1 else mlstm_chunked
    hs, C, n, m = run(q, k, v, log_i, log_f, C0, n0, m0)
    hs = hs.reshape(B, S, H * hd).to(x.dtype)
    hs = rmsnorm(params["out_norm"], hs, cfg.norm_eps) * gate
    out = shard(torch.matmul(hs, params["w_down"]), ("batch", "seq", "embed"))
    cache = None
    if layer_cache is not None:
        cache = {"C": C, "n": n, "m": m}
    return out, cache


def init_mlstm_cache(cfg, batch: int, device, lead: tuple = ()) -> PyTree:
    H = cfg.num_heads
    hd = _MLSTM_EXP * cfg.d_model // H
    lead = tuple(lead)
    return {"C": torch.zeros(lead + (batch, H, hd, hd), dtype=F32,
                             device=device),
            "n": torch.zeros(lead + (batch, H, hd), dtype=F32, device=device),
            "m": torch.zeros(lead + (batch, H), dtype=F32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM scalar memory, sequential)
# ---------------------------------------------------------------------------
# Per head-channel: c_t = f c_{t-1} + i z;  n_t = f n_{t-1} + i;
# h_t = o * c_t / n_t, with exp input gate (m-stabilized), sigmoid output
# gate, and recurrent weights (block-diag per head) feeding all gates.

_SLSTM_FF = 4 / 3


def slstm_init(gen, cfg, device, lead: tuple = ()) -> PyTree:
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    dt = cdtype(cfg)
    lead = tuple(lead)
    d_ff = int(_SLSTM_FF * d)
    return {
        "norm": rmsnorm_init(d, device, lead),
        # input weights for z, i, f, o
        "w_in": dense_init(gen, (d, 4 * d), d, dt, device, lead),
        # recurrent weights, block-diagonal per head: (H, hd, 4*hd), fan-in
        # hd (the reference's in_axis=1)
        "w_rec": dense_init(gen, (H, hd, 4 * hd), hd, dt, device, lead),
        "b": _gate_bias(((2 * d, 0.0), (d, 3.0), (d, 0.0)), lead, device),
        "out_norm": rmsnorm_init(d, device, lead),
        # post-FFN (xLSTM sLSTM block, factor 4/3)
        "ff_up": dense_init(gen, (d, d_ff), d, dt, device, lead),
        "ff_gate": dense_init(gen, (d, d_ff), d, dt, device, lead),
        "ff_down": dense_init(gen, (d_ff, d), d_ff, dt, device, lead),
    }


def slstm_apply(params: PyTree, x: torch.Tensor, cfg, *, mode: str,
                layer_cache: Optional[PyTree] = None
                ) -> tuple[torch.Tensor, Optional[PyTree]]:
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H
    xin = rmsnorm(params["norm"], x, cfg.norm_eps)
    pre = torch.matmul(xin, params["w_in"]).to(F32) + params["b"].to(F32)

    if layer_cache is None:
        c = torch.zeros((B, D), dtype=F32, device=x.device)
        n = torch.ones((B, D), dtype=F32, device=x.device)
        m = torch.zeros((B, D), dtype=F32, device=x.device)
        h = torch.zeros((B, D), dtype=F32, device=x.device)
    else:
        c, n, m, h = (layer_cache[k] for k in ("c", "n", "m", "h"))

    w_rec = params["w_rec"].to(F32)
    n_floor = torch.tensor(1e-6, dtype=F32, device=x.device)
    hs = []
    for t in range(S):
        rec = torch.einsum("bhk,hke->bhe", h.reshape(B, H, hd), w_rec)
        zr, ir, fr, orr = torch.split(pre[:, t] + rec.reshape(B, 4 * D), D,
                                      dim=-1)
        z = torch.tanh(zr)
        log_i = ir
        log_f = F.logsigmoid(fr)
        m_new = torch.maximum(log_f + m, log_i)
        fa = torch.exp(log_f + m - m_new)
        ia = torch.exp(log_i - m_new)
        c = fa * c + ia * z
        n = fa * n + ia
        h = torch.sigmoid(orr) * c / torch.maximum(n, n_floor)
        m = m_new
        hs.append(h)
    hs = torch.stack(hs, dim=1).to(x.dtype)              # (B,S,D)
    hs = rmsnorm(params["out_norm"], hs, cfg.norm_eps)
    # block FFN (gated, factor 4/3)
    a = F.silu(torch.matmul(hs, params["ff_gate"]))
    u = torch.matmul(hs, params["ff_up"])
    out = shard(torch.matmul(a * u, params["ff_down"]),
                ("batch", "seq", "embed"))
    cache = None
    if layer_cache is not None:
        cache = {"c": c, "n": n, "m": m, "h": h}
    return out, cache


def init_slstm_cache(cfg, batch: int, device, lead: tuple = ()) -> PyTree:
    shape = tuple(lead) + (batch, cfg.d_model)
    return {"c": torch.zeros(shape, dtype=F32, device=device),
            "n": torch.ones(shape, dtype=F32, device=device),
            "m": torch.zeros(shape, dtype=F32, device=device),
            "h": torch.zeros(shape, dtype=F32, device=device)}
