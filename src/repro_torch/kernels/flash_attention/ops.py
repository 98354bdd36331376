"""Wrapper for the flash-attention kernel: (B, S, H, hd) layout, GQA by
kv-head indexing, suffix alignment (q_offset = Sk - Sq by default) and a
valid kv length.

Dispatch is by the device of q: a CPU tensor takes the plain version
(ref.py), a CUDA tensor launches csrc/flash_attention.cu (or raises).
The kernel takes ragged lengths and indexes kv head h // (H // K), so
there is no padding and no repeat of k and v. Forward only: there is no
backward kernel yet, and asking for a gradient raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.ref import attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("flash_attention")
    if lib.fa_flash_attention.argtypes is None:
        lib.fa_flash_attention.argtypes = [_P, _P, _P, _P] + [_I] * 11 + [
            ctypes.c_float, _P]
        lib.fa_flash_attention.restype = _I
        lib.fa_supports_head_dim.argtypes = [_I]
        lib.fa_supports_head_dim.restype = _I
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: Optional[int] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H % K == 0. Query row
    i sits at absolute position q_offset + i (default Sk - Sq); keys at
    positions >= kv_len (default Sk) are masked. Returns (B, Sq, H, hd)
    in q's dtype; a row with no valid key is 0."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only: its backward kernel comes "
            "with the training slice")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"flash_attention: {H} heads over {K} kv heads")
    q_offset = Sk - Sq if q_offset is None else int(q_offset)
    kv_len = Sk if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not f32/bf16")
    lib = _lib()
    if not lib.fa_supports_head_dim(hd):
        raise ValueError(f"flash_attention: no kernel for head_dim {hd}")
    dev = q.device
    runtime.require(q, q.dtype, (B, Sq, H, hd), "flash_attention q", dev)
    runtime.require(k, q.dtype, (B, Sk, K, hd), "flash_attention k", dev)
    runtime.require(v, q.dtype, (B, Sk, K, hd), "flash_attention v", dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name}: not 16-byte aligned")
    out = torch.empty_like(q)
    if B * Sq * H == 0:
        return out
    err = lib.fa_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, K, hd, _DTYPES[q.dtype], int(causal), int(window), q_offset,
        kv_len, 1.0 / math.sqrt(hd), runtime.stream_ptr(q))
    runtime.check(err, "flash_attention")
    runtime.note_launch("flash_attention")
    return out
