"""Wrappers for the worker-batched 3x3 stride-1 "SAME" convolution: C
workers' f32 weights over their own images in one launch, forward (the
bias in its epilogue), input gradient and weight-and-bias gradient.

`worker_conv(x, w, b)` is one worker's convolution as the model writes
it (x (N, Cin, H, W), w (3, 3, Cin, Cout) HWIO, b (Cout,)). Under
`torch.func.vmap` its autograd Functions' vmap rules write the worker
dimension out, so `vmap(grad(loss))` over C workers and `vmap` of the
scoring forward under `no_grad` reach one launch per convolution for
all C workers; an input that vmap does not batch (the images of D_g,
which every worker scores) is read by every worker through a worker
stride of 0, never copied C times. An unbatched call is C = 1.

The launches are operators (`runtime.register_op`:
repro_torch::worker_conv, worker_conv_dgrad, worker_conv_wgrad): a CPU
tensor takes the plain versions (ref.py, the vmapped `F.conv2d` and its
autograd), a CUDA tensor csrc/worker_conv.cu (or raises), a fake one
the shape rules. The kernel plans its own launches from the shapes
(`plan`); `takes` sends a model's convolution here only where the plans
fit (`fits`), so the models' wider layers stay the library's.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.worker_conv.ref import (worker_conv_dgrad_ref,
                                                 worker_conv_ref,
                                                 worker_conv_wgrad_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@dataclass(frozen=True)
class Plan:
    """A launch as csrc/worker_conv.cu plans it: `imgs` images a block
    (forward, input gradient; grid (ceil(N / imgs), C)) or a staged
    chunk (weight gradient; grid (ceil(Cout / ct), C)), `threads` a
    block, `ct` output channels a thread at a time, the weight
    gradient's pixel `groups` (0 otherwise) and the block's shared
    memory in bytes."""
    imgs: int
    threads: int
    ct: int
    groups: int
    smem: int


def _lib() -> ctypes.CDLL:
    lib = runtime.library("worker_conv")
    if lib.wc_forward.argtypes is None:
        shape = [_I] * 6
        lib.wc_plan.argtypes = [_I] + shape + [ctypes.POINTER(_I)]
        lib.wc_forward.argtypes = [_P, _L, _P, _P, _P] + shape + [_P]
        lib.wc_dgrad.argtypes = [_P, _P, _P] + shape + [_P]
        lib.wc_wgrad.argtypes = [_P, _L, _P, _P, _P] + shape + [_P]
        for f in (lib.wc_plan, lib.wc_forward, lib.wc_dgrad, lib.wc_wgrad):
            f.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def plan(wgrad: bool, C: int, N: int, K: int, M: int, H: int, W: int
         ) -> Plan | None:
    """The kernel's plan of a launch (the weight gradient's if `wgrad`,
    else the forward's, K = Cin into M = Cout, or the input gradient's,
    K = Cout into M = Cin), None where the shape does not fit it."""
    out = (_I * 5)()
    if _lib().wc_plan(int(wgrad), C, N, K, M, H, W, out):
        return None
    return Plan(*out)


@functools.lru_cache(maxsize=None)
def fits(cin: int, cout: int, H: int, W: int) -> bool:
    """Whether all three kernels take a cin -> cout convolution of H x W
    images (the limits do not depend on the number of images or
    workers)."""
    return None not in (plan(False, 1, 1, cin, cout, H, W),
                        plan(False, 1, 1, cout, cin, H, W),
                        plan(True, 1, 1, cin, cout, H, W))


def _shapes(x, w, shared):
    """(C, N, K, M, H, W) of x (C, or 1 if shared, N, K, H, W), w (C, 3,
    3, K, M)."""
    if x.ndim != 5 or w.ndim != 5 or tuple(w.shape[1:3]) != (3, 3):
        raise ValueError(f"worker_conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}: want (C, N, Cin, H, W) and "
                         f"(C, 3, 3, Cin, Cout)")
    C, K, M = w.shape[0], w.shape[3], w.shape[4]
    if x.shape[0] != (1 if shared else C) or x.shape[2] != K:
        raise ValueError(f"worker_conv: x {tuple(x.shape)} against w "
                         f"{tuple(w.shape)}")
    return C, x.shape[1], K, M, x.shape[3], x.shape[4]


def _f32(*ts) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise ValueError(f"worker_conv: dtype {t.dtype}, f32 only")


def _images_arg(x: torch.Tensor, shared: bool) -> tuple[torch.Tensor, int]:
    """x contiguous, and its worker stride: 0 where every worker reads
    the one set of images."""
    x = x.contiguous()
    return x, 0 if shared else x[0].numel()


def _conv_cuda(x, w, b, shared):
    runtime.require_cuda(w)
    _f32(x, w, b)
    C, N, K, M, H, W = _shapes(x, w, shared)
    dev = w.device
    (x, xs), w, b = _images_arg(x, shared), w.contiguous(), b.contiguous()
    runtime.require(b, torch.float32, (C, M), "worker_conv b", dev)
    y = torch.empty((C, N, M, H, W), device=dev, dtype=torch.float32)
    if y.numel() == 0:
        return y
    err = _lib().wc_forward(x.data_ptr(), xs, w.data_ptr(),
                            b.data_ptr(), y.data_ptr(), C, N, K, M, H, W,
                            runtime.stream_ptr(w))
    runtime.check(err, "worker_conv")
    runtime.note_launch("worker_conv", C)
    return y


def _dgrad_cuda(gy, w):
    runtime.require_cuda(w)
    _f32(gy, w)
    C, N, M, H, W = gy.shape       # the kernel reads Cout channels
    K = w.shape[3]                 # and writes Cin
    dev = w.device
    gy, w = gy.contiguous(), w.contiguous()
    runtime.require(w, torch.float32, (C, 3, 3, K, M), "worker_conv_dgrad w",
                    dev)
    dx = torch.empty((C, N, K, H, W), device=dev, dtype=torch.float32)
    if dx.numel() == 0:
        return dx
    err = _lib().wc_dgrad(gy.data_ptr(), w.data_ptr(), dx.data_ptr(), C, N,
                          M, K, H, W, runtime.stream_ptr(w))
    runtime.check(err, "worker_conv_dgrad")
    runtime.note_launch("worker_conv_dgrad", C)
    return dx


def _wgrad_cuda(x, gy, shared):
    runtime.require_cuda(gy)
    _f32(x, gy)
    C, N, M, H, W = gy.shape
    K = x.shape[2]
    dev = gy.device
    if tuple(x.shape) != (1 if shared else C, N, K, H, W):
        raise ValueError(f"worker_conv_wgrad: x {tuple(x.shape)} against "
                         f"gy {tuple(gy.shape)}")
    (x, xs), gy = _images_arg(x, shared), gy.contiguous()
    runtime.require(x, torch.float32, x.shape, "worker_conv_wgrad x", dev)
    dw = torch.empty((C, 3, 3, K, M), device=dev, dtype=torch.float32)
    db = torch.empty((C, M), device=dev, dtype=torch.float32)
    if dw.numel() == 0:
        return dw, db
    if N * H * W == 0:
        return dw.zero_(), db.zero_()
    err = _lib().wc_wgrad(x.data_ptr(), xs, gy.data_ptr(),
                          dw.data_ptr(), db.data_ptr(), C, N, K, M, H, W,
                          runtime.stream_ptr(gy))
    runtime.check(err, "worker_conv_wgrad")
    runtime.note_launch("worker_conv_wgrad", C)
    return dw, db


def _conv_fake(x, w, b, shared):
    _f32(x, w, b)
    C, N, K, M, H, W = _shapes(x, w, shared)
    return x.new_empty((C, N, M, H, W))


def _dgrad_fake(gy, w):
    _f32(gy, w)
    C, N, _, H, W = gy.shape
    return gy.new_empty((C, N, w.shape[3], H, W))


def _wgrad_fake(x, gy, shared):
    _f32(x, gy)
    C, _, M = gy.shape[:3]
    return gy.new_empty((C, 3, 3, x.shape[2], M)), gy.new_empty((C, M))


def _conv_cost(x, w, b, shared):
    """2 x 9 x Cin operations an output element and its bias add; x, w,
    b read once (shared images once), y written once."""
    C, N, K, M, H, W = _shapes(x, w, shared)
    out = C * N * M * H * W
    return out * (18 * K + 1), 4 * (x.numel() + w.numel() + b.numel() + out)


def _dgrad_cost(gy, w):
    C, N, M, H, W = gy.shape
    K = w.shape[3]
    out = C * N * K * H * W
    return out * 18 * M, 4 * (gy.numel() + w.numel() + out)


def _wgrad_cost(x, gy, shared):
    """2 x 9 x Cin operations a gradient element of gy for the weights,
    one for the bias; x and gy read once, dw and db written once."""
    C, N, M, H, W = gy.shape
    K = x.shape[2]
    g = gy.numel()
    return g * (18 * K + 1), 4 * (x.numel() + g + C * M * (9 * K + 1))


WORKER_CONV = runtime.register_op(
    "worker_conv", "(Tensor x, Tensor w, Tensor b, bool shared) -> Tensor",
    cuda=_conv_cuda, cpu=worker_conv_ref, fake=_conv_fake, cost=_conv_cost)
WORKER_CONV_DGRAD = runtime.register_op(
    "worker_conv_dgrad", "(Tensor gy, Tensor w) -> Tensor",
    cuda=_dgrad_cuda, cpu=worker_conv_dgrad_ref, fake=_dgrad_fake,
    cost=_dgrad_cost)
WORKER_CONV_WGRAD = runtime.register_op(
    "worker_conv_wgrad",
    "(Tensor x, Tensor gy, bool shared) -> (Tensor, Tensor)",
    cuda=_wgrad_cuda, cpu=worker_conv_wgrad_ref, fake=_wgrad_fake,
    cost=_wgrad_cost)


def conv_raw(x, w, b, shared=False):
    """x (C, N, Cin, H, W), or (1, N, Cin, H, W) images that every worker
    reads if `shared`; w (C, 3, 3, Cin, Cout), b (C, Cout), f32 -> y (C,
    N, Cout, H, W)."""
    fn = _conv_cuda if runtime.direct(w) else WORKER_CONV
    return fn(x, w, b, shared)


def dgrad_raw(gy, w):
    """gy (C, N, Cout, H, W), w (C, 3, 3, Cin, Cout) -> dx (C, N, Cin, H,
    W)."""
    return (_dgrad_cuda if runtime.direct(w) else WORKER_CONV_DGRAD)(gy, w)


def wgrad_raw(x, gy, shared=False):
    """x as `conv_raw`'s, gy (C, N, Cout, H, W) -> (dw (C, 3, 3, Cin,
    Cout), db (C, Cout))."""
    fn = _wgrad_cuda if runtime.direct(gy) else WORKER_CONV_WGRAD
    return fn(x, gy, shared)


def _front(t, dim, size):
    """t with vmap's batch dim `dim` in front, or the one copy expanded
    to `size` workers where vmap does not batch it."""
    return t.expand((size,) + t.shape) if dim is None else t.movedim(dim, 0)


def _images(x, dim):
    """(x with the worker dim in front, whether every worker reads one
    set of images): vmap does not batch x (in_dim None) where every
    worker scores the same images, which the kernel reads through a
    worker stride of 0, never copied C times."""
    return (x[None], True) if dim is None else (x.movedim(dim, 0), False)


class _Conv(torch.autograd.Function):
    """One worker's y = conv(x, w) + b; x (N, Cin, H, W), w (3, 3, Cin,
    Cout), b (Cout,)."""

    @staticmethod
    def forward(x, w, b):
        return conv_raw(x[None], w[None], b[None])[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        return _Backward.apply(x, gy, w, ctx.needs_input_grad[0])

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        C = info.batch_size
        x, shared = _images(x, in_dims[0])
        return conv_raw(x, _front(w, in_dims[1], C),
                        _front(b, in_dims[2], C), shared), 0


class _Backward(torch.autograd.Function):
    """The gradients of `_Conv` in one call (none of their own): the
    input's where `needs_dx` (conv1's input is the images), the weight's
    and the bias's. Under vmap(grad) each call of an autograd Function
    costs the host more than its launches."""

    @staticmethod
    def forward(x, gy, w, needs_dx):
        dw, db = wgrad_raw(x[None], gy[None])
        dx = dgrad_raw(gy[None], w[None])[0] if needs_dx else None
        return dx, dw[0], db[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, gx, gw, gb):
        raise NotImplementedError("worker_conv: no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, gy, w, needs_dx):
        C = info.batch_size
        x, shared = _images(x, in_dims[0])
        gy = _front(gy, in_dims[1], C)
        dw, db = wgrad_raw(x, gy, shared)
        if not needs_dx:
            return (None, dw, db), (None, 0, 0)
        return (dgrad_raw(gy, _front(w, in_dims[2], C)), dw, db), (0, 0, 0)


def on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def takes(x: torch.Tensor, w: torch.Tensor, stride: int) -> bool:
    """Whether a model's convolution (x (N, Cin, H, W), an HWIO weight)
    is the kernel's: 3x3, stride 1 (so "SAME" pads 1 on every side), f32
    on the card, at channels and image sizes that its plans fit."""
    return (tuple(w.shape[:2]) == (3, 3) and stride == 1
            and x.dtype == w.dtype == torch.float32 and on_card(x)
            and fits(w.shape[2], w.shape[3], x.shape[-2], x.shape[-1]))


def worker_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """One worker's 3x3 "SAME" convolution plus bias: x (N, Cin, H, W),
    w (3, 3, Cin, Cout), b (Cout,), f32 -> (N, Cout, H, W);
    differentiable in all three, and vmappable over any of them."""
    return _Conv.apply(x, w, b)
