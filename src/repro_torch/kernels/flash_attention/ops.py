"""Wrappers for the flash-attention kernels: (B, S, H, hd) layout, GQA by
kv-head indexing, suffix alignment (q_offset = Sk - Sq by default) and a
valid kv length.

Dispatch is by the device of q: a CPU tensor takes the plain versions
(ref.py), a CUDA tensor launches csrc/flash_attention.cu and, for the
gradient, csrc/flash_attention_bwd.cu (or raises). The kernels take
ragged lengths and index kv head h // (H // K), so there is no padding
and no repeat of k and v.

`flash_attention` is differentiable: when a gradient is wanted it runs
as an autograd Function whose forward also keeps each row's
log-sum-exp, and whose backward is the backward kernel (the plain
backward on the CPU). Without a gradient (serve, evaluation) it is the
forward alone.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("flash_attention")
    if lib.fa_flash_attention.argtypes is None:
        lib.fa_flash_attention.argtypes = [_P] * 5 + [_I] * 11 + [
            ctypes.c_float, _P]
        lib.fa_flash_attention.restype = _I
        lib.fa_supports_head_dim.argtypes = [_I]
        lib.fa_supports_head_dim.restype = _I
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = runtime.library("flash_attention_bwd")
    if lib.fa_flash_attention_bwd.argtypes is None:
        lib.fa_flash_attention_bwd.argtypes = [_P] * 10 + [_I] * 11 + [
            ctypes.c_float, _P]
        lib.fa_flash_attention_bwd.restype = _I
        lib.fa_bwd_supports_head_dim.argtypes = [_I]
        lib.fa_bwd_supports_head_dim.restype = _I
    return lib


def _shapes(q, k, q_offset, kv_len):
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"flash_attention: {H} heads over {K} kv heads")
    q_offset = Sk - Sq if q_offset is None else int(q_offset)
    kv_len = Sk if kv_len is None else int(kv_len)
    return B, Sq, Sk, H, K, hd, q_offset, kv_len


def _require_cuda(q, what):
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {q.dtype} not f32/bf16")


def _check(dev, dtype, named: dict) -> None:
    for name, (t, shape) in named.items():
        runtime.require(t, dtype, shape, f"flash_attention {name}", dev)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name}: not 16-byte aligned")


def _forward(q, k, v, causal, window, q_offset, kv_len, want_lse: bool):
    """(out, lse or None); lse is (B, H, Sq) f32."""
    B, Sq, Sk, H, K, hd, q_offset, kv_len = _shapes(q, k, q_offset, kv_len)
    if q.device.type == "cpu":
        out, lse = attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len,
                                 return_lse=True)
        return out, (lse if want_lse else None)
    _require_cuda(q, "flash_attention")
    lib = _lib()
    if not lib.fa_supports_head_dim(hd):
        raise ValueError(f"flash_attention: no kernel for head_dim {hd}")
    _check(q.device, q.dtype, {"q": (q, (B, Sq, H, hd)),
                               "k": (k, (B, Sk, K, hd)),
                               "v": (v, (B, Sk, K, hd))})
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if B * Sq * H == 0:
        return out, lse
    err = lib.fa_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Sk, H, K, hd,
        _DTYPES[q.dtype], int(causal), int(window), q_offset, kv_len,
        1.0 / math.sqrt(hd), runtime.stream_ptr(q))
    runtime.check(err, "flash_attention")
    runtime.note_launch("flash_attention")
    return out, lse


def require_bwd_head_dim(hd: int) -> None:
    """Raise on a head dim the backward kernel is not built for, as its
    library says."""
    if not _bwd_lib().fa_bwd_supports_head_dim(hd):
        raise ValueError(f"flash_attention backward: no kernel for "
                         f"head_dim {hd}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_offset: Optional[int] = None,
                        kv_len: Optional[int] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of `flash_attention` given its inputs, its
    output, the output's gradient and the forward's (B, H, Sq) f32
    log-sum-exp. dq is (B, Sq, H, hd) and dk, dv (B, Sk, K, hd), in q's
    dtype; rows with no valid key get zero gradient."""
    B, Sq, Sk, H, K, hd, q_offset, kv_len = _shapes(q, k, q_offset, kv_len)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                                 window=window, q_offset=q_offset,
                                 kv_len=kv_len)
    _require_cuda(q, "flash_attention backward")
    require_bwd_head_dim(hd)
    dev = q.device
    _check(dev, q.dtype, {"q": (q, (B, Sq, H, hd)), "k": (k, (B, Sk, K, hd)),
                          "v": (v, (B, Sk, K, hd)),
                          "out": (out, (B, Sq, H, hd)),
                          "dout": (dout, (B, Sq, H, hd))})
    runtime.require(lse, torch.float32, (B, H, Sq), "flash_attention lse",
                    dev)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    if B * Sq * H == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    err = _bwd_lib().fa_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, K, hd, _DTYPES[q.dtype],
        int(causal), int(window), q_offset, kv_len, 1.0 / math.sqrt(hd),
        runtime.stream_ptr(q))
    runtime.check(err, "flash_attention backward")
    runtime.note_launch("flash_attention_bwd")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a backward: the forward kernel keeps the
    log-sum-exp and the backward kernel recomputes P from it. Under
    `torch.utils.checkpoint` the recompute runs this forward again, so
    the tensors the backward reads come from the recompute."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_len):
        if q.device.type != "cpu":
            require_bwd_head_dim(q.shape[-1])    # fail before the forward
        out, lse = _forward(q, k, v, causal, window, q_offset, kv_len,
                            want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, q_offset, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, kv_len = ctx.masks
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, causal=causal,
            window=window, q_offset=q_offset, kv_len=kv_len)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: Optional[int] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H % K == 0. Query row
    i sits at absolute position q_offset + i (default Sk - Sq); keys at
    positions >= kv_len (default Sk) are masked. Returns (B, Sq, H, hd)
    in q's dtype; a row with no valid key is 0. Differentiable in q, k
    and v."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    kv_len)
    return _forward(q, k, v, causal, window, q_offset, kv_len,
                    want_lse=False)[0]
