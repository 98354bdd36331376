"""Non-i.i.d. degree metric (paper §II, Eq. 2):

    eta_i = 1 - Normalize(beta1 * |L_i|/|L_g| + beta2 * W_i + phi)

with W_i the 1-D Wasserstein distance between the worker's and the
global label marginal, |L_i|/|L_g| the fraction of global label types
present locally, and Normalize min-max scaling over the fleet.
`fit_eta_coefficients` is the paper's §V-C least-squares fit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def label_histogram(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Counts per class: int labels of any shape -> (num_classes,) f32."""
    return torch.bincount(labels.reshape(-1).to(torch.int64),
                          minlength=num_classes)[:num_classes].to(
        torch.float32)


def label_distribution(labels: torch.Tensor,
                       num_classes: int) -> torch.Tensor:
    """Normalized label marginal; uniform for an empty dataset."""
    hist = label_histogram(labels, num_classes)
    total = hist.sum()
    if total > 0:
        return hist / total
    return torch.full_like(hist, 1.0 / num_classes)


def wasserstein_1d(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """W1 between label marginals on the ordered alphabet:
    sum_k |CDF_p(k) - CDF_q(k)|."""
    return (torch.cumsum(p, 0) - torch.cumsum(q, 0)).abs().sum()


def label_ratio(local_hist: torch.Tensor,
                global_hist: torch.Tensor) -> torch.Tensor:
    """|L_i| / |L_g|: fraction of globally present label types present
    locally."""
    present_local = (local_hist > 0) & (global_hist > 0)
    present_global = (global_hist > 0).sum().to(torch.float32)
    return present_local.sum().to(torch.float32) / torch.clamp(
        present_global, min=1.0)


def minmax_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Min-max scaling across the worker population."""
    lo, hi = x.min(), x.max()
    return (x - lo) / torch.clamp(hi - lo, min=eps)


class EtaCoefficients(NamedTuple):
    """Fitted coefficients of Eq. 2 (paper §V-C values below)."""
    beta1: float
    beta2: float
    phi: float


CIFAR10_COEFFS = EtaCoefficients(beta1=0.286, beta2=-0.07, phi=0.592)
MNIST_COEFFS = EtaCoefficients(beta1=-0.031, beta2=0.127, phi=-0.04)


def noniid_features(local_labels: torch.Tensor, global_labels: torch.Tensor,
                    num_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-worker raw features (label_ratio, W_i) of Eq. 2."""
    local_hist = label_histogram(local_labels, num_classes)
    global_hist = label_histogram(global_labels, num_classes)
    p = label_distribution(local_labels, num_classes)
    q = label_distribution(global_labels, num_classes)
    return label_ratio(local_hist, global_hist), wasserstein_1d(p, q)


def noniid_degree(ratios: torch.Tensor, wds: torch.Tensor,
                  coeffs: EtaCoefficients = CIFAR10_COEFFS) -> torch.Tensor:
    """Eq. 2 as a DEGREE: the fitted affine form is an accuracy proxy
    (high = iid-like), so eta is its min-max-normalized complement —
    1 = most heterogeneous, which Eq. 5/6 selection penalizes."""
    raw = coeffs.beta1 * ratios + coeffs.beta2 * wds + coeffs.phi
    return 1.0 - minmax_normalize(raw)


def noniid_degree_from_labels(per_worker_labels: torch.Tensor,
                              global_labels: torch.Tensor, num_classes: int,
                              coeffs: EtaCoefficients = CIFAR10_COEFFS
                              ) -> torch.Tensor:
    """eta for stacked (C, n_i) int labels + (n_g,) global labels."""
    feats = [noniid_features(lab, global_labels, num_classes)
             for lab in per_worker_labels]
    ratios = torch.stack([f[0] for f in feats])
    wds = torch.stack([f[1] for f in feats])
    return noniid_degree(ratios, wds, coeffs)


def fit_eta_coefficients(ratios: np.ndarray, wds: np.ndarray,
                         accuracies: np.ndarray, train_frac: float = 0.9,
                         seed: int = 0
                         ) -> tuple[EtaCoefficients, float, float]:
    """Least-squares fit of Eq. 2 to observed accuracy (paper §V-C) on a
    90/10 split. Returns (coeffs, R^2 train, R^2 test)."""
    n = len(accuracies)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = max(int(round(train_frac * n)), 2)
    tr, te = perm[:n_train], perm[n_train:]

    def design(idx):
        return np.stack([ratios[idx], wds[idx], np.ones(len(idx))], axis=1)

    sol, *_ = np.linalg.lstsq(design(tr), accuracies[tr], rcond=None)
    coeffs = EtaCoefficients(beta1=float(sol[0]), beta2=float(sol[1]),
                             phi=float(sol[2]))

    def r2(idx):
        if len(idx) == 0:
            return float("nan")
        resid = accuracies[idx] - design(idx) @ sol
        tot = accuracies[idx] - accuracies[idx].mean()
        denom = float((tot ** 2).sum())
        if denom == 0.0:
            return 1.0 if float((resid ** 2).sum()) < 1e-12 else 0.0
        return 1.0 - float((resid ** 2).sum()) / denom

    return coeffs, r2(tr), r2(te)
