"""Worker dataset partitioning (paper §V-A): the C stacked local datasets
plus the shared synthetic evaluation set D_g and an i.i.d. test set,
under the three regimes of §V-B:

  iid          every worker draws labels uniformly
  non-iid I    every worker's label proportions ~ Dirichlet(alpha=0.5)
  non-iid II   mixed fleet (Fig. 2): groups of workers at different alpha

All draws for one partition come from `seed`: a torch.Generator on the
target device for labels and images, a numpy Generator for the
Dirichlet proportions.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.data import synthetic
from repro_torch.data.synthetic import SyntheticImageSpec
from repro_torch.kernels.runtime import resolve_device


class FederatedData(NamedTuple):
    x: torch.Tensor          # (C, n_i, H, W, ch)
    y: torch.Tensor          # (C, n_i) int64
    global_x: torch.Tensor   # (n_g, H, W, ch) — D_g
    global_y: torch.Tensor   # (n_g,)
    test_x: torch.Tensor     # held-out i.i.d. test set
    test_y: torch.Tensor
    alphas: torch.Tensor     # (C,) generation parameter per worker


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _build(gen: torch.Generator, labels: torch.Tensor,
           spec: SyntheticImageSpec, n_global: int, n_test: int,
           alphas: torch.Tensor) -> FederatedData:
    dev = labels.device
    prototypes = synthetic.make_class_prototypes(gen, spec, dev)
    local_x = synthetic.sample_images(gen, labels, prototypes, spec)
    gy = synthetic.uniform_labels(gen, (n_global,), spec.num_classes, dev)
    gx = synthetic.sample_images(gen, gy, prototypes, spec)
    ty = synthetic.uniform_labels(gen, (n_test,), spec.num_classes, dev)
    tx = synthetic.sample_images(gen, ty, prototypes, spec)
    return FederatedData(x=local_x, y=labels, global_x=gx, global_y=gy,
                         test_x=tx, test_y=ty, alphas=alphas)


def iid_partition(seed: int, num_workers: int, spec: SyntheticImageSpec,
                  n_local: int = 512, n_global: int = 2048,
                  n_test: int = 2048, device=None) -> FederatedData:
    device = resolve_device(device)
    gen = _generator(seed, device)
    labels = synthetic.uniform_labels(gen, (num_workers, n_local),
                                      spec.num_classes, device)
    alphas = torch.full((num_workers,), float("inf"), device=device)
    return _build(gen, labels, spec, n_global, n_test, alphas)


def dirichlet_partition(seed: int, num_workers: int, alpha: float,
                        spec: SyntheticImageSpec, n_local: int = 512,
                        n_global: int = 2048, n_test: int = 2048,
                        device=None) -> FederatedData:
    """Non-i.i.d. case I: one alpha across the fleet."""
    return mixed_dirichlet_partition(seed, [(num_workers, alpha)], spec,
                                     n_local, n_global, n_test, device)


def mixed_dirichlet_partition(seed: int, groups: Sequence[tuple[int, float]],
                              spec: SyntheticImageSpec, n_local: int = 512,
                              n_global: int = 2048, n_test: int = 2048,
                              device=None) -> FederatedData:
    """Non-i.i.d. case II (Fig. 2): `groups` is [(count, alpha), ...]."""
    device = resolve_device(device)
    gen = _generator(seed, device)
    rng = np.random.default_rng(seed)
    alphas = np.concatenate([np.full(cnt, a, np.float32)
                             for cnt, a in groups])
    labels = synthetic.sample_labels_dirichlet(gen, rng, alphas, n_local,
                                               spec.num_classes, device)
    return _build(gen, labels, spec, n_global, n_test,
                  torch.as_tensor(alphas, device=device))
