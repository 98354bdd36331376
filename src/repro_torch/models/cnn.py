"""Paper-experiment models: the 5-layer CNN of DSL [9] and a compact
ResNet, functional over nested-dict params.

The public layouts are the JAX package's: conv weights HWIO, dense
weights (in, out), images NHWC. `apply` converts to PyTorch's OIHW/NCHW
inside, so params and inputs carry across from the JAX package
unchanged. Padding follows XLA's "SAME" rule (asymmetric for stride 2).
On the card a 3x3 stride-1 f32 convolution is the `worker_conv` kernel
(under `vmap`, one launch for all the workers); every other convolution,
and every one on the CPU, is `F.conv2d`. Models are (init, apply)
pairs: init(gen) -> params, apply(params, x[N,H,W,C]) -> logits[N,L];
`torch.func.vmap` over stacked params runs the C workers together.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import resolve_device
from repro_torch.kernels.worker_conv import ops as worker_conv_ops

PyTree = Any


class ImageModel(NamedTuple):
    init: Callable[[torch.Generator], PyTree]
    apply: Callable[[PyTree, torch.Tensor], torch.Tensor]
    name: str


def _conv_init(gen, kh, kw, cin, cout, device):
    fan_in = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=gen,
                    device=device) * math.sqrt(2.0 / fan_in)
    return {"w": w, "b": torch.zeros((cout,), device=device)}


def _dense_init(gen, din, dout, device):
    w = torch.randn((din, dout), generator=gen,
                    device=device) * math.sqrt(2.0 / din)
    return {"w": w, "b": torch.zeros((dout,), device=device)}


def _same(n: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(p, x, stride=1):
    """NCHW conv with an HWIO weight and XLA 'SAME' padding."""
    if worker_conv_ops.takes(x, p["w"], stride):
        return worker_conv_ops.worker_conv(x, p["w"], p["b"])
    w = p["w"].permute(3, 2, 0, 1)
    kh, kw = w.shape[-2:]
    (ht, hb), (wl, wr) = (_same(x.shape[-2], kh, stride),
                          _same(x.shape[-1], kw, stride))
    if ht == hb and wl == wr:
        y = F.conv2d(x, w, stride=stride, padding=(ht, wl))
    else:
        y = F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride)
    return y + p["b"].reshape(-1, 1, 1)


def _dense(p, x):
    return x @ p["w"] + p["b"]


def _nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def make_cnn5(height: int, width: int, channels: int, num_classes: int,
              width_mult: int = 8, device=None) -> ImageModel:
    """Five-layer CNN [9]: conv-pool, conv-pool, conv, dense, dense.
    `device`: where `init` draws; None is the card (`resolve_device`)."""
    device = resolve_device(device)
    c1, c2, c3 = width_mult, 2 * width_mult, 2 * width_mult
    feat = (height // 4) * (width // 4) * c3
    hidden = 4 * width_mult

    def init(gen: torch.Generator) -> PyTree:
        return {
            "conv1": _conv_init(gen, 3, 3, channels, c1, device),
            "conv2": _conv_init(gen, 3, 3, c1, c2, device),
            "conv3": _conv_init(gen, 3, 3, c2, c3, device),
            "fc1": _dense_init(gen, feat, hidden, device),
            "fc2": _dense_init(gen, hidden, num_classes, device),
        }

    def apply(params: PyTree, x: torch.Tensor) -> torch.Tensor:
        x = _nhwc_to_nchw(x)
        x = F.max_pool2d(F.relu(_conv(params["conv1"], x)), 2)
        x = F.max_pool2d(F.relu(_conv(params["conv2"], x)), 2)
        x = F.relu(_conv(params["conv3"], x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        x = F.relu(_dense(params["fc1"], x))
        return _dense(params["fc2"], x)

    return ImageModel(init=init, apply=apply, name=f"cnn5_w{width_mult}")


def make_resnet(height: int, width: int, channels: int, num_classes: int,
                width_mult: int = 8, blocks_per_stage: int = 2,
                device=None) -> ImageModel:
    """Compact normalization-free ResNet (2 stages x `blocks_per_stage`
    residual blocks) — the paper's ResNet18 at reduced width. `device`
    as `make_cnn5`'s."""
    device = resolve_device(device)
    c1, c2 = width_mult, 2 * width_mult

    def block_init(gen, cin, cout):
        p = {"conv_a": _conv_init(gen, 3, 3, cin, cout, device),
             "conv_b": _conv_init(gen, 3, 3, cout, cout, device)}
        if cin != cout:
            p["proj"] = _conv_init(gen, 1, 1, cin, cout, device)
        return p

    def block_apply(p, x, stride):
        h = F.relu(_conv(p["conv_a"], x, stride))
        h = _conv(p["conv_b"], h)
        skip = _conv(p["proj"], x, stride) if "proj" in p else x
        return F.relu(skip + 0.5 * h)

    def init(gen: torch.Generator) -> PyTree:
        p = {"stem": _conv_init(gen, 3, 3, channels, c1, device)}
        cin = c1
        for stage, cout in enumerate((c1, c2)):
            for b in range(blocks_per_stage):
                p[f"s{stage}b{b}"] = block_init(gen, cin, cout)
                cin = cout
        p["head"] = _dense_init(gen, c2, num_classes, device)
        return p

    def apply(params: PyTree, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_conv(params["stem"], _nhwc_to_nchw(x)))
        for stage in range(2):
            for b in range(blocks_per_stage):
                stride = 2 if (b == 0 and stage > 0) else 1
                x = block_apply(params[f"s{stage}b{b}"], x, stride)
        return _dense(params["head"], x.mean(dim=(2, 3)))

    return ImageModel(init=init, apply=apply, name=f"resnet_w{width_mult}")
