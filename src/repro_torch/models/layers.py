"""Shared transformer layers of the port (init/apply pairs over dict
params), as the JAX package's `models/layers.py`.

Conventions, as there: params are nested dicts of tensors; x is
(B, S, D) and attention internals (B, S, H, hd); matmuls run in the
config dtype, norms, rotary angles and softmax in f32. An init function
takes a `torch.Generator`, the device and `lead`, a tuple of leading
dims (the stacked layer groups), and draws one leaf at a time.

Attention over a whole sequence (train, prefill) goes through
`kernels.flash_attention` (the CUDA kernel on a card, the plain version
on the CPU) where the reference calls its XLA twin `chunked_attention`;
when a gradient is wanted (training) that is its autograd Function
(forward kernel with the log-sum-exp, backward kernel), where the
reference differentiates `chunked_attention` through XLA.
Decode attends one token over the cache with a grouped product, as the
reference does. Caches are written in place (`index_copy_`) and
returned; their `pos` is a Python int, so decode never syncs the host.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention

PyTree = Any
F32 = torch.float32


def cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: Optional[torch.Generator], shape: tuple, fan_in: int,
               dtype: torch.dtype, device, lead: tuple = ()
               ) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in f32, then cast (the reference's
    `dense_init`; fan_in is its `shape[in_axis]`)."""
    x = torch.randn(tuple(lead) + tuple(shape), generator=gen, device=device,
                    dtype=F32)
    return (x / math.sqrt(fan_in)).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device, lead: tuple = ()) -> PyTree:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=F32, device=device)}


def rmsnorm(params: PyTree, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embedding_init(gen, vocab: int, d: int, dtype, device) -> PyTree:
    tbl = torch.randn((vocab, d), generator=gen, device=device, dtype=F32)
    return {"table": (tbl * 0.01).to(dtype)}


def embed(params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["table"])


def unembed(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: (B,S,D) @ (V,D)^T -> (B,S,V), in x's dtype."""
    return torch.matmul(x, params["table"].t())


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,). Applies RoPE in f32."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=F32, device=x.device) *
                      (math.log(theta) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(F32) * freqs            # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA; full-causal / sliding-window; train, prefill, decode)
# ---------------------------------------------------------------------------

def attention_init(gen, cfg, device, lead: tuple = ()) -> PyTree:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, k = cfg.num_heads, cfg.num_kv_heads
    dt = cdtype(cfg)
    return {
        "norm": rmsnorm_init(d, device, lead),
        "wq": dense_init(gen, (d, h, hd), d, dt, device, lead),
        "wk": dense_init(gen, (d, k, hd), d, dt, device, lead),
        "wv": dense_init(gen, (d, k, hd), d, dt, device, lead),
        "wo": dense_init(gen, (h, hd, d), h, dt, device, lead),
    }


def _project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,D) x (D,N,hd) -> (B,S,N,hd) as one matmul."""
    B, S, D = h.shape
    return torch.matmul(h, w.reshape(D, -1)).reshape(B, S, *w.shape[1:])


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cur: int, window: int) -> torch.Tensor:
    """One step over the cache (layers.py:273-304): q (B,S,H,hd), k/v
    (B,T,K,hd); `cur` is the new token's absolute position. Scores and
    softmax in f32, p cast to the cache dtype before the PV product."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    kv_pos = torch.arange(T, device=q.device)
    if window and T <= window:
        # ring: slot j holds position p iff p % T == j; every slot is
        # valid once the ring has wrapped
        mask = None if cur >= T else kv_pos <= cur % T
    else:
        mask = kv_pos <= cur
        if window:
            mask = mask & (kv_pos > cur - window)
    qg = q.reshape(B, S, K, H // K, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg.to(F32), k.to(F32))
    s = s / math.sqrt(hd)
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).to(F32),
                       v.to(F32))
    return out.reshape(B, S, H, hd)


def attention_apply(params: PyTree, x: torch.Tensor, cfg, *, mode: str,
                    layer_cache: Optional[PyTree] = None,
                    window: int = 0) -> tuple[torch.Tensor, Optional[PyTree]]:
    """One self-attention sub-block (pre-norm; the caller adds the
    residual). mode: "train" | "prefill" | "decode".

    layer_cache: {"k", "v": (B, S_cache, K, hd) (S_cache = window for the
    sliding-window ring), "pos": int tokens already written}. Returns
    (out, new_cache); the cache tensors are updated in place."""
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(
            f"attention mode {mode!r} (the encoder) is not ported yet")
    if mode == "decode" and layer_cache is None:
        raise ValueError("decode attends over a cache: pass layer_cache")
    B, S, D = x.shape
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    q = _project(h, params["wq"])
    k = _project(h, params["wk"])
    v = _project(h, params["wv"])

    pos = 0 if layer_cache is None else int(layer_cache["pos"])
    positions = pos + torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if layer_cache is not None and mode in ("prefill", "decode"):
        ck, cv = layer_cache["k"], layer_cache["v"]
        cache_len = ck.shape[1]
        kk, vv, idx = k, v, positions[0, :] % cache_len
        if mode == "prefill" and window and cache_len < S:
            # keep the last `cache_len` tokens in the ring
            kk, vv = k[:, -cache_len:], v[:, -cache_len:]
            idx = positions[0, -cache_len:] % cache_len
        ck.index_copy_(1, idx, kk.to(ck.dtype))
        cv.index_copy_(1, idx, vv.to(cv.dtype))
        new_cache = {"k": ck, "v": cv, "pos": pos + S}

    if mode == "decode":
        out = _decode_attention(q, ck, cv, pos + S - 1, window).to(x.dtype)
    else:
        out = flash_attention(q, k, v, causal=True, window=window)
    y = torch.matmul(out.reshape(B, S, -1),
                     params["wo"].reshape(-1, params["wo"].shape[-1]))
    return y, new_cache


def init_attention_cache(cfg, batch: int, cache_len: int, window: int,
                         dtype, device, lead: tuple = ()) -> PyTree:
    k_heads, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    size = min(cache_len, window) if window else cache_len
    shape = tuple(lead) + (batch, size, k_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, cfg, device, lead: tuple = ()
             ) -> PyTree:
    dt = cdtype(cfg)
    return {
        "norm": rmsnorm_init(d, device, lead),
        "wi": dense_init(gen, (d, d_ff), d, dt, device, lead),      # gate
        "wu": dense_init(gen, (d, d_ff), d, dt, device, lead),      # up
        "wo": dense_init(gen, (d_ff, d), d_ff, dt, device, lead),   # down
    }


def mlp_apply(params: PyTree, x: torch.Tensor, cfg) -> torch.Tensor:
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    a = F.silu(torch.matmul(h, params["wi"]))
    b = torch.matmul(h, params["wu"])
    return torch.matmul(a * b, params["wo"])
