"""Plain PyTorch version of flash attention: the dense masked softmax of
the JAX package's `attention_ref`, in the (B, S, H, hd) layout of the
ops wrapper, with the GQA head repeat, a valid kv length and the
all-masked-row -> 0 rule. The oracle of csrc/flash_attention.cu."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_mask(Sq: int, Sk: int, *, causal: bool, window: int,
                   q_offset: int, kv_len: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: query i (absolute position q_offset + i) may see
    key j."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H % K == 0. Scores,
    softmax and P.V in f32; returns (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    g = H // K
    f32 = torch.float32
    qf = q.to(f32).transpose(1, 2)                                 # B,H,Sq,hd
    kf = k.to(f32).transpose(1, 2).repeat_interleave(g, dim=1)     # B,H,Sk,hd
    vf = v.to(f32).transpose(1, 2).repeat_interleave(g, dim=1)
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          q_offset=q_offset,
                          kv_len=Sk if kv_len is None else kv_len,
                          device=q.device)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    s.masked_fill_(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    del s
    p.masked_fill_(~mask, 0.0)            # rows with no valid key -> 0
    out = torch.matmul(p, vf)
    return out.transpose(1, 2).contiguous().to(q.dtype)
