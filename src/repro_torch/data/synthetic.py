"""Synthetic class-conditional image data (the offline stand-in for
MNIST/CIFAR10): each class has a fixed random spatial prototype, low-pass
filtered and re-standardized; a sample is prototype * contrast + noise.
Images are NHWC, as in the JAX package.

Draws come from an explicit `torch.Generator` (on the data's device);
the Dirichlet class proportions come from a numpy Generator, since
torch's Dirichlet sampler takes no generator. The port does not
reproduce the JAX package's random streams — parity runs inject the
reference's arrays instead (`experiments.runner.build(data=...)`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class SyntheticImageSpec(NamedTuple):
    name: str
    height: int
    width: int
    channels: int
    num_classes: int
    noise_scale: float = 0.8
    prototype_scale: float = 1.0


MNIST_LIKE = SyntheticImageSpec("mnist_like", 28, 28, 1, 10, noise_scale=0.6)
CIFAR_LIKE = SyntheticImageSpec("cifar_like", 32, 32, 3, 10, noise_scale=1.0)


def blur_and_standardize(raw: torch.Tensor,
                         spec: SyntheticImageSpec) -> torch.Tensor:
    """The deterministic half of the prototypes: two 3x3 box blurs with
    edge padding, then per-class re-standardization. raw: (L, H, W, C)."""
    H, W = spec.height, spec.width

    def blur(x):
        pad = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                    mode="replicate").permute(0, 2, 3, 1)
        acc = sum(pad[:, i:i + H, j:j + W, :]
                  for i in range(3) for j in range(3))
        return acc / 9.0

    smooth = blur(blur(raw))
    mean = smooth.mean(dim=(1, 2, 3), keepdim=True)
    std = smooth.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
    return spec.prototype_scale * (smooth - mean) / (std + 1e-6)


def make_class_prototypes(gen: torch.Generator, spec: SyntheticImageSpec,
                          device) -> torch.Tensor:
    """(num_classes, H, W, C) prototypes."""
    raw = torch.randn((spec.num_classes, spec.height, spec.width,
                       spec.channels), generator=gen, device=device)
    return blur_and_standardize(raw, spec)


def sample_images(gen: torch.Generator, labels: torch.Tensor,
                  prototypes: torch.Tensor,
                  spec: SyntheticImageSpec) -> torch.Tensor:
    """prototype[label] * contrast + noise, for labels of any leading
    shape."""
    base = prototypes[labels]
    lead = labels.shape
    contrast = 1.0 + 0.3 * torch.randn(lead + (1, 1, 1), generator=gen,
                                       device=base.device)
    noise = spec.noise_scale * torch.randn(base.shape, generator=gen,
                                           device=base.device)
    return base * contrast + noise


def sample_labels_dirichlet(gen: torch.Generator, rng: np.random.Generator,
                            alphas, n: int, num_classes: int,
                            device) -> torch.Tensor:
    """(C, n) labels, worker i with class proportions ~ Dir(alphas[i])
    (paper's generation scheme [6]: small alpha = strong label skew)."""
    props = np.stack([rng.dirichlet(np.full(num_classes, float(a)))
                      for a in alphas])
    probs = torch.as_tensor(props + 1e-12, dtype=torch.float32,
                            device=device)
    return torch.multinomial(probs, n, replacement=True, generator=gen)


def sample_dataset(gen: torch.Generator, labels: torch.Tensor,
                   prototypes: torch.Tensor, spec: SyntheticImageSpec
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, y) for given labels (compat shim over sample_images)."""
    return sample_images(gen, labels, prototypes, spec), labels


def uniform_labels(gen: torch.Generator, shape, num_classes: int,
                   device) -> torch.Tensor:
    return torch.randint(0, num_classes, tuple(shape), generator=gen,
                         device=device)
