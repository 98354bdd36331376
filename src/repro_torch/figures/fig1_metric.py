"""Paper Fig. 1 + §V-C on the port: data-heterogeneity quantification,
the counterpart of the JAX package's `benchmarks/fig1_metric.py`.

Sweeps the Dirichlet concentration alpha, measures for each fleet
  * mean label-ratio |L_i|/|L_g|,
  * mean 1-D Wasserstein distance W_i,
  * the fitted non-i.i.d. degree eta (Eq. 2),
and trains FedAvg briefly to get the accuracy trend. Reproduces the
paper's claims that (a) eta tracks the accuracy trend while WD and
label-ratio alone leave gaps, and (b) the least-squares fit of Eq. 2 to
accuracy is strongly linear (paper: R^2 = 0.97 MNIST / 0.895 CIFAR10).

    python -m repro_torch.figures.fig1_metric [--full] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import noniid
from repro_torch.data import partition
from repro_torch.data.synthetic import CIFAR_LIKE, MNIST_LIKE
from repro_torch.experiments import override
from repro_torch.experiments import run as run_spec
from repro_torch.experiments.runner import spec_from_paper_kwargs
from repro_torch.figures.common import print_table, save_record
from repro_torch.kernels.runtime import resolve_device

ALPHAS_QUICK = [0.01, 0.1, 0.5, 1.0, 10.0, 100.0]
ALPHAS_FULL = [0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 100.0, 1000.0]


def measure_fleet(alpha: float, dataset: str, num_workers: int,
                  seed: int, device) -> tuple[float, float]:
    """Mean label ratio and mean W_i of a Dirichlet(alpha) fleet (the
    port's seeded partition, on `device`)."""
    spec = MNIST_LIKE if dataset == "mnist_like" else CIFAR_LIKE
    data = partition.dirichlet_partition(seed, num_workers, alpha, spec,
                                         device=device)
    feats = [noniid.noniid_features(lab, data.global_y, spec.num_classes)
             for lab in data.y]
    ratios = torch.stack([f[0] for f in feats])
    wds = torch.stack([f[1] for f in feats])
    return float(ratios.mean()), float(wds.mean())


def run(quick: bool = True, dataset: str = "mnist_like",
        num_workers: int = 0, rounds: int = 0, seed: int = 0,
        device=None) -> dict:
    device = resolve_device(device)
    alphas = ALPHAS_QUICK if quick else ALPHAS_FULL
    num_workers = num_workers or (10 if quick else 50)
    rounds = rounds or (4 if quick else 10)
    ratios, wds, accs = [], [], []
    for a in alphas:
        r, w = measure_fleet(a, dataset, num_workers, seed, device)
        rec = _fedavg_at(a, dataset, num_workers, rounds, seed, device)
        ratios.append(r)
        wds.append(w)
        accs.append(rec["final_acc"])

    ratios_np, wds_np = np.array(ratios), np.array(wds)
    accs_np = np.array(accs)
    coeffs, r2_train, r2_test = noniid.fit_eta_coefficients(
        ratios_np, wds_np, accs_np)
    norm = lambda a: noniid.minmax_normalize(  # noqa: E731
        torch.as_tensor(a, dtype=torch.float32))   # f32, as jnp's default
    eta = norm(coeffs.beta1 * ratios_np + coeffs.beta2 * wds_np
               + coeffs.phi)
    acc_n, wd_n, ratio_n = norm(accs_np), norm(wds_np), norm(ratios_np)

    # Fig-1 gap statistics: |metric - normalized accuracy| per alpha
    gap = lambda m: float((m - acc_n).abs().mean())  # noqa: E731
    gaps = {"eta": gap(eta), "one_minus_wd": gap(1 - wd_n),
            "label_ratio": gap(ratio_n)}

    rows = [[a, f"{r:.3f}", f"{w:.3f}", f"{ac:.3f}", f"{float(e):.3f}"]
            for a, r, w, ac, e in zip(alphas, ratios, wds, accs, eta)]
    print_table(["alpha", "label_ratio", "WD", "fedavg_acc", "eta"],
                rows, "Fig. 1 — heterogeneity metrics vs FedAvg accuracy")
    print(f"Eq. 2 fit: beta1={coeffs.beta1:.3f} beta2={coeffs.beta2:.3f} "
          f"phi={coeffs.phi:.3f}  R2(train)={r2_train:.3f} "
          f"R2(test)={r2_test:.3f}")
    print(f"mean |metric - acc| gaps (lower = tracks accuracy better): "
          f"eta={gaps['eta']:.3f}  1-WD={gaps['one_minus_wd']:.3f}  "
          f"label-ratio={gaps['label_ratio']:.3f}")

    rec = {"alphas": alphas, "label_ratio": ratios, "wd": wds,
           "fedavg_acc": accs, "eta": eta.tolist(),
           "coeffs": list(coeffs), "r2_train": r2_train, "r2_test": r2_test,
           "gaps": gaps, "dataset": dataset}
    save_record("fig1_metric", rec)
    return rec


def _fedavg_at(alpha, dataset, num_workers, rounds, seed, device,
               n_local=256):
    """FedAvg on a Dirichlet(alpha) fleet (`data.alpha`)."""
    spec = spec_from_paper_kwargs(
        algorithm="fedavg", case="noniid1", dataset=dataset, rounds=rounds,
        num_workers=num_workers, width_mult=2, local_epochs=2,
        n_local=n_local, lr=0.05, seed=seed)
    return run_spec(override(spec, f"data.alpha={alpha}"), verbose=False,
                    device=device).record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="ten alphas, C=50, 10 rounds")
    ap.add_argument("--quick", action="store_true",
                    help="six alphas, C=10, 4 rounds (the default)")
    ap.add_argument("--dataset", default="mnist_like")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.full and args.quick:
        ap.error("--full and --quick are mutually exclusive")
    run(quick=not args.full, dataset=args.dataset, seed=args.seed,
        device=args.device)


if __name__ == "__main__":
    main()
