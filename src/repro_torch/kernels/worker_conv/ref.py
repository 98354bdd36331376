"""Plain PyTorch version of the worker-batched 3x3 stride-1 "SAME"
convolution: C workers' weights over their own images (or over one
set of images all workers share), the oracle of csrc/worker_conv.cu.

Each function is what `torch.func.vmap` makes of `F.conv2d` and of its
autograd (`convolution_backward`, the bias's `sum_to_size`) over the
worker dimension, called through `vmap` itself: the same batching rules,
so the same grouped calls, layouts and bits as the model's vmapped
convolution without the operator.

Layouts: x (C, N, Cin, H, W), or (1, N, Cin, H, W) with `shared` where
every worker reads one set of images (vmap's in_dim None); w (C, 3, 3,
Cin, Cout) (the models' HWIO leaf, a worker dimension in front); b (C,
Cout); y and gy (C, N, Cout, H, W).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_ONE, _PAD = [1, 1], [1, 1]


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(0, 4, 3, 1, 2)


def _x_dim(x: torch.Tensor, shared: bool):
    """vmap's in_dim of x, and what it maps over."""
    return (None, x[0]) if shared else (0, x)


def _bwd(g, x, w, mask):
    return torch.ops.aten.convolution_backward(
        g, x, w, None, _ONE, _PAD, _ONE, False, [0, 0], 1, mask)


def worker_conv_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    shared: bool) -> torch.Tensor:
    """y[c] = conv2d(x[c] (x[0] if shared), w[c], padding 1) + b[c]."""
    xd, xs = _x_dim(x, shared)
    y = torch.vmap(lambda xi, wi: F.conv2d(xi, wi, padding=1),
                   in_dims=(xd, 0))(xs, _oihw(w))
    return torch.vmap(lambda yi, bi: yi + bi.reshape(-1, 1, 1))(y, b)


def worker_conv_dgrad_ref(gy: torch.Tensor, w: torch.Tensor
                          ) -> torch.Tensor:
    """The input gradient (C, N, Cin, H, W) of `worker_conv_ref`."""
    C, N, _, H, W = gy.shape
    x = gy.new_zeros((C, N, w.shape[3], H, W))
    return torch.vmap(lambda g, xi, wi: _bwd(g, xi, wi,
                                             [True, False, False])[0])(
        gy, x, _oihw(w))


def worker_conv_wgrad_ref(x: torch.Tensor, gy: torch.Tensor, shared: bool
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight gradient (C, 3, 3, Cin, Cout) and bias gradient
    (C, Cout) of `worker_conv_ref`."""
    C, cout = gy.shape[0], gy.shape[2]
    xd, xs = _x_dim(x, shared)
    w = gy.new_zeros((C, cout, x.shape[2], 3, 3))
    dw = torch.vmap(lambda g, xi, wi: _bwd(g, xi, wi,
                                           [False, True, False])[1],
                    in_dims=(0, xd, 0))(gy, xs, w)
    db = torch.vmap(lambda g: g.sum_to_size((cout, 1, 1)).reshape(cout))(gy)
    return dw.permute(0, 3, 4, 2, 1), db
