"""Loss functions (paper Eq. 3): per-sample RMSE between the softmax
vector and the one-hot label, cross-entropy, and accuracy.

The one-hot is built by comparison, not `F.one_hot`, so the losses run
under `torch.func.vmap` (one_hot checks its input's range on the host).
"""
from __future__ import annotations

import torch


def _one_hot(labels: torch.Tensor, num_classes: int,
             dtype: torch.dtype) -> torch.Tensor:
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def rmse_loss(logits: torch.Tensor, labels: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """Eq. 3: mean over samples of sqrt(||softmax(logits) - onehot||^2)."""
    probs = torch.softmax(logits, dim=-1)
    one_hot = _one_hot(labels, num_classes, probs.dtype)
    per_sample = torch.sqrt(((probs - one_hot) ** 2).sum(dim=-1) + 1e-12)
    return per_sample.mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int) -> torch.Tensor:
    log_probs = torch.log_softmax(logits, dim=-1)
    one_hot = _one_hot(labels, num_classes, logits.dtype)
    return -(one_hot * log_probs).sum(dim=-1).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()


LOSSES = {"rmse": rmse_loss, "xent": cross_entropy_loss}
