"""Wrappers for the flash-attention kernels: (B, S, H, hd) layout, GQA by
kv-head indexing, suffix alignment (q_offset = Sk - Sq by default) and a
valid kv length.

Dispatch is by the device of q: a CPU tensor takes the plain versions
(ref.py), a CUDA tensor launches csrc/flash_attention.cu and, for the
gradient, csrc/flash_attention_bwd.cu (or raises). The kernels take
ragged lengths and index kv head h // (H // K), so there is no padding
and no repeat of k and v.

Head dims: every hd with hd % 8 == 0 up to 256 has a launch. The
kernels are built for 32, 64, 128 and 256 (`HEAD_DIMS`); another hd runs
in the next of them (`padded_head_dim`, the wrappers' check; the
libraries' `fa_supports_head_dim` / `fa_bwd_supports_head_dim` give the
same answer), its columns from hd on read as zeros inside the kernel
(TMA fills them; the CUDA-core kernels skip the loads) and never
stored, with the scale 1/sqrt(hd). No padded copy is made. The
tensor-core kernels, forward and backward, are also built for 80
(`TC_HEAD_DIMS`, `tc_head_dim`, one rule for both directions): hd 72 and
80 run there, not in the 128 build.

On the card the route is chosen by dtype and head dim alone, before the
launch: bf16 at hd 33-256 launches the tensor-core kernels (forward and
backward each in its 64, 80, 128 or 256 build) and counts as
`flash_attention` / `flash_attention_bwd`; f32, and bf16 at hd <= 32,
launches the CUDA-core kernels and counts as `flash_attention_f32` /
`flash_attention_bwd_f32`.

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
from repro_torch.sharding import boundary
from repro_torch.sharding.rules import is_dtensor
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)        # the kernels' instantiations
TC_HEAD_DIMS = (64, 80, 128, 256)     # the tensor-core kernels' builds


def padded_head_dim(hd: int) -> int:
    """The instantiation head dim `hd` runs in: the next of HEAD_DIMS (as
    csrc/flash_wgmma.cuh `padded_head_dim`). Raises ValueError unless
    hd % 8 == 0 and 0 < hd <= 256 (TMA's rows are 16-byte multiples)."""
    if hd <= 0 or hd > HEAD_DIMS[-1] or hd % 8:
        raise ValueError(f"flash_attention: no kernel for head_dim {hd} "
                         f"(hd % 8 == 0 and hd <= 256)")
    return next(d for d in HEAD_DIMS if d >= hd)


def tc_head_dim(hd: int) -> int:
    """The build of the bf16 tensor-core kernels, forward and backward,
    that head dim `hd` (33 to 256) runs in: the next of TC_HEAD_DIMS (as
    csrc/flash_wgmma.cuh `tc_head_dim`)."""
    padded_head_dim(hd)
    if hd <= 32:
        raise ValueError(f"flash_attention: head_dim {hd} runs on the CUDA "
                         f"cores, not the tensor cores")
    return next(d for d in TC_HEAD_DIMS if d >= hd)


def _lib() -> ctypes.CDLL:
    lib = runtime.library("flash_attention")
    if lib.fa_flash_attention.argtypes is None:
        lib.fa_flash_attention.argtypes = [_P] * 5 + [_I] * 11 + [
            ctypes.c_float, _P]
        lib.fa_flash_attention.restype = _I
        lib.fa_supports_head_dim.argtypes = [_I]
        lib.fa_supports_head_dim.restype = _I
        lib.fa_flash_attention_tc.argtypes = [_P] * 5 + [_I] * 10 + [
            ctypes.c_float, _P]
        lib.fa_flash_attention_tc.restype = _I
        lib.fa_tc_supports_head_dim.argtypes = [_I]
        lib.fa_tc_supports_head_dim.restype = _I
        lib.fa_tc_build_head_dim.argtypes = [_I]
        lib.fa_tc_build_head_dim.restype = _I
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = runtime.library("flash_attention_bwd")
    if lib.fa_flash_attention_bwd.argtypes is None:
        lib.fa_flash_attention_bwd.argtypes = [_P] * 10 + [_I] * 11 + [
            ctypes.c_float, _P]
        lib.fa_flash_attention_bwd.restype = _I
        lib.fa_bwd_supports_head_dim.argtypes = [_I]
        lib.fa_bwd_supports_head_dim.restype = _I
        lib.fa_flash_attention_bwd_tc.argtypes = [_P] * 10 + [_I] * 10 + [
            ctypes.c_float, _P]
        lib.fa_flash_attention_bwd_tc.restype = _I
        lib.fa_bwd_tc_supports_head_dim.argtypes = [_I]
        lib.fa_bwd_tc_supports_head_dim.restype = _I
        lib.fa_bwd_tc_build_head_dim.argtypes = [_I]
        lib.fa_bwd_tc_build_head_dim.restype = _I
        lib.fa_bwd_tc_scratch_floats.argtypes = [_I] * 6
        lib.fa_bwd_tc_scratch_floats.restype = ctypes.c_longlong
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


def _check(dev, dtype, named: dict, tma: bool = False) -> None:
    """Device, dtype, shape, contiguity and a 16-byte aligned base; for
    the tensor-core kernels (`tma`) also the byte strides of the
    (B, S, heads, hd) layout, which TMA needs in multiples of 16."""
    for name, (t, shape) in named.items():
        runtime.require(t, dtype, shape, f"flash_attention {name}", dev)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention {name}: not 16-byte aligned")
        if tma and any(st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError(f"flash_attention {name}: strides "
                             f"{t.stride()} not multiples of 16 bytes")


def _forward(q, k, v, causal, window, q_offset, kv_len, want_lse: bool):
    """(out, lse or None); lse is (B, H, Sq) f32."""
    B, Sq, Sk, H, K, hd, q_offset, kv_len = _shapes(q, k, q_offset, kv_len)
    if q.device.type == "cpu":
        out, lse = attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len,
                                 return_lse=True)
        return out, (lse if want_lse else None)
    _require_cuda(q, "flash_attention")
    padded_head_dim(hd)                   # raises on a head dim with no launch
    lib = _lib()
    tc = q.dtype == torch.bfloat16 and bool(lib.fa_tc_supports_head_dim(hd))
    _check(q.device, q.dtype, {"q": (q, (B, Sq, H, hd)),
                               "k": (k, (B, Sk, K, hd)),
                               "v": (v, (B, Sk, K, hd))}, tma=tc)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if B * Sq * H == 0:
        return out, lse
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Sk, H, K, hd)
    masks = (int(causal), int(window), q_offset, kv_len,
             1.0 / math.sqrt(hd), runtime.stream_ptr(q))
    if tc:
        err = lib.fa_flash_attention_tc(*args, *masks)
    else:
        err = lib.fa_flash_attention(*args, _DTYPES[q.dtype], *masks)
    runtime.check(err, "flash_attention")
    runtime.note_launch("flash_attention" if tc else "flash_attention_f32")
    return out, lse


def require_bwd_head_dim(hd: int) -> None:
    """Raise on a head dim the backward kernels have no launch for: the
    forward's rule (`padded_head_dim`), and what their library says it
    is built for."""
    padded_head_dim(hd)
    if not _bwd_lib().fa_bwd_supports_head_dim(hd):
        raise ValueError(f"flash_attention backward: no kernel for "
                         f"head_dim {hd} (hd % 8 == 0 and hd <= 256)")


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
    lib = _bwd_lib()
    tc = q.dtype == torch.bfloat16 and bool(
        lib.fa_bwd_tc_supports_head_dim(hd))
    _check(dev, q.dtype, {"q": (q, (B, Sq, H, hd)), "k": (k, (B, Sk, K, hd)),
                          "v": (v, (B, Sk, K, hd)),
                          "out": (out, (B, Sq, H, hd)),
                          "dout": (dout, (B, Sq, H, hd))}, tma=tc)
    runtime.require(lse, torch.float32, (B, H, Sq), "flash_attention lse",
                    dev)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    if B * Sq * H == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # scratch: dsum (B, H, Sq); the tensor-core kernels take dsum and a
    # copy of lse, each zero-padded to a multiple of 64 rows, and the
    # partial dK, dV of head groups where they split the grid (the
    # library sizes it)
    n = (int(lib.fa_bwd_tc_scratch_floats(B, Sq, Sk, H, K, hd)) if tc
         else B * H * Sq)
    scratch = torch.empty(n, dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, K, hd)
    masks = (int(causal), int(window), q_offset, kv_len,
             1.0 / math.sqrt(hd), runtime.stream_ptr(q))
    if tc:
        err = lib.fa_flash_attention_bwd_tc(*args, *masks)
    else:
        err = lib.fa_flash_attention_bwd(*args, _DTYPES[q.dtype], *masks)
    runtime.check(err, "flash_attention backward")
    runtime.note_launch("flash_attention_bwd" if tc
                        else "flash_attention_bwd_f32")
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
    and v. DTensor inputs run on each rank's shards where their layout
    allows (`sharding.boundary.attention`)."""
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        return boundary.attention(flash_attention, q, k, v, causal=causal,
                                  window=window, q_offset=q_offset,
                                  kv_len=kv_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    kv_len)
    return _forward(q, k, v, causal, window, q_offset, kv_len,
                    want_lse=False)[0]
