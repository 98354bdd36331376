"""The paper's 5-layer CNN [9] over C stacked workers, in plain PyTorch:
conv 3x3 (c) - relu - maxpool 2, conv 3x3 (2c) - relu - maxpool 2, conv
3x3 (2c) - relu, dense (4c) - relu, dense (classes). Weights HWIO and
dense (in, out), images NHWC, as the configuration file lays them out.
The C workers run as one grouped convolution (groups = C) and batched
products; `padding=1` is "SAME" for a 3x3 stride-1 kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

LEAVES = ("conv1", "conv2", "conv3", "fc1", "fc2")


def _conv(x: torch.Tensor, p: dict, C: int) -> torch.Tensor:
    """x (N, C cin, H, W); p["w"] (C, 3, 3, cin, cout), p["b"] (C, cout)."""
    w = p["w"]
    cin, cout = w.shape[3], w.shape[4]
    w = w.permute(0, 4, 3, 1, 2).reshape(C * cout, cin, 3, 3)
    return F.conv2d(x, w, p["b"].reshape(C * cout), padding=1, groups=C)


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """params: leaves with a leading worker dim C; x (C, N, H, W, ch)
    -> logits (C, N, classes)."""
    C, N, H, W, ch = x.shape
    h = x.permute(1, 0, 4, 2, 3).reshape(N, C * ch, H, W)
    h = F.max_pool2d(F.relu(_conv(h, params["conv1"], C)), 2)
    h = F.max_pool2d(F.relu(_conv(h, params["conv2"], C)), 2)
    h = F.relu(_conv(h, params["conv3"], C))
    c3, h3, w3 = h.shape[1] // C, h.shape[2], h.shape[3]
    # each worker's features in NHWC order
    h = h.reshape(N, C, c3, h3, w3).permute(1, 0, 3, 4, 2).reshape(C, N, -1)
    h = F.relu(torch.baddbmm(params["fc1"]["b"][:, None], h,
                             params["fc1"]["w"]))
    return torch.baddbmm(params["fc2"]["b"][:, None], h, params["fc2"]["w"])


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(C,) mean cross-entropy of each worker's (N, classes) logits."""
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, y[..., None])[..., 0].mean(dim=-1)


def rmse(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(C,) paper Eq. 3: mean over samples of the Euclidean distance
    between softmax(logits) and the one-hot label."""
    p = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(y, p.shape[-1]).to(p.dtype)
    return torch.sqrt(((p - onehot) ** 2).sum(-1) + 1e-12).mean(dim=-1)


def score(params: dict, x: torch.Tensor, y: torch.Tensor,
          block: int = 256) -> torch.Tensor:
    """(C,) Eq.-3 loss of every worker's params on one shared set x (N,
    H, W, ch), y (N,), a block of samples at a time."""
    C = params["fc2"]["b"].shape[0]
    total = None
    with torch.no_grad():
        for s in range(0, x.shape[0], block):
            xb = x[s:s + block].expand((C,) + tuple(x[s:s + block].shape))
            yb = y[s:s + block].expand(C, -1)
            part = rmse(apply(params, xb), yb) * xb.shape[1]
            total = part if total is None else total + part
    return total / x.shape[0]


def grads(params: dict, x: torch.Tensor, y: torch.Tensor) -> dict:
    """Every worker's gradient of its own mean cross-entropy on its
    minibatch x (C, N, ...), y (C, N): the workers' losses are summed,
    and no worker's loss depends on another's params."""
    leaves = {k: {n: t.detach().requires_grad_() for n, t in v.items()}
              for k, v in params.items()}
    flat = [t for v in leaves.values() for t in v.values()]
    with torch.enable_grad():
        loss = cross_entropy(apply(leaves, x), y).sum()
        g = torch.autograd.grad(loss, flat)
    it = iter(g)
    return {k: {n: next(it) for n in v} for k, v in leaves.items()}
