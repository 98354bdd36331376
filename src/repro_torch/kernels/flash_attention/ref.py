"""Plain PyTorch versions of flash attention and its backward.

`attention_ref` is the dense masked softmax of the JAX package's
`attention_ref`, in the (B, S, H, hd) layout of the ops wrapper, with
the GQA head repeat, a valid kv length and the all-masked-row -> 0 rule
(and, on request, each row's log-sum-exp): the oracle of
csrc/flash_attention.cu. `attention_bwd_ref` is the gradient written out
step by step from the same log-sum-exp: the oracle of
csrc/flash_attention_bwd.cu."""
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


def _heads_f32(q, k, v):
    """(B, H, S, hd) f32 views of q and of k, v repeated per query head."""
    g = q.shape[2] // k.shape[2]
    f32 = torch.float32
    return (q.to(f32).transpose(1, 2),
            k.to(f32).transpose(1, 2).repeat_interleave(g, dim=1),
            v.to(f32).transpose(1, 2).repeat_interleave(g, dim=1))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  kv_len: Optional[int] = None, return_lse: bool = False):
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H % K == 0. Scores,
    softmax and P.V in f32; returns (B, Sq, H, hd) in q's dtype, and
    with `return_lse` also the (B, H, Sq) f32 log-sum-exp of each row's
    scaled scores (-inf for a row with no valid key)."""
    Sq, hd = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    qf, kf, vf = _heads_f32(q, k, v)
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          q_offset=q_offset,
                          kv_len=Sk if kv_len is None else kv_len,
                          device=q.device)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    s.masked_fill_(~mask, -math.inf)
    lse = torch.logsumexp(s, dim=-1) if return_lse else None
    p = torch.softmax(s, dim=-1)
    del s
    # rows with no valid key -> 0 (out of place: softmax's backward
    # reads its output when this runs under autograd)
    p = p.masked_fill(~mask, 0.0)
    out = torch.matmul(p, vf).transpose(1, 2).contiguous().to(q.dtype)
    return (out, lse) if return_lse else out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor,
                      lse: torch.Tensor, *, causal: bool = True,
                      window: int = 0, q_offset: int = 0,
                      kv_len: Optional[int] = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of `attention_ref` from its output `out`,
    the output gradient `dout` and the forward's (B, H, Sq) log-sum-exp,
    in f32, returned in q's dtype; dk and dv are summed over the query
    heads that share a kv head. A row with no valid key gets 0."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = _heads_f32(q, k, v)
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          q_offset=q_offset,
                          kv_len=Sk if kv_len is None else kv_len,
                          device=q.device)
    # P = exp(S * scale - lse), 0 where the mask is false
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    del s
    do = dout.to(f32).transpose(1, 2)                          # B,H,Sq,hd
    dsum = (do * out.to(f32).transpose(1, 2)).sum(-1)          # rowsum(dO*O)
    dv = torch.matmul(p.transpose(-1, -2), do)                 # B,H,Sk,hd
    dp = torch.matmul(do, vf.transpose(-1, -2))                # B,H,Sq,Sk
    ds = p * (dp - dsum[..., None])
    del p, dp
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale

    def per_kv_head(x):        # (B, H, Sk, hd) -> (B, Sk, K, hd)
        return x.reshape(B, K, H // K, Sk, hd).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).contiguous().to(q.dtype),
            per_kv_head(dk).contiguous().to(q.dtype),
            per_kv_head(dv).contiguous().to(q.dtype))
