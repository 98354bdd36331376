"""Eqs. 5-6 and 9-10 applied to the program's own numbers, to judge the
decisions it took in each checked round. Round-off moves the losses
that two sound runs compare, so the reference cannot judge a decision
by its own losses; it judges it by the program's: the scores theta and
the mask from the program's losses and eta, the thresholds and bests
from the program's state before the round (the algorithm's start, +inf,
before round 1). Every entry that differs is counted, exactly; the cell
compares the count with the limit 0.

A round's record (one per checked round, tensors on the device the
program ran on, so that each formula reruns with the program's own
kernels):
  losses  (C,) the workers' losses after the round (Eq. 3 on D_g)
  theta   (C,) Eq. 5's scores        mask  (C,) Eq. 6's selection
  mean    () the threshold left for the next round (mean theta)
  eta     (C,) the non-i.i.d. degrees the scores used
  pre     (C,) the losses that Eq. 9 compared with the bests: the
          round's starting params' (paper engine; from round 2 on the
          previous round's `losses`) or its new params' (mesh engine)
  best    (C,) the workers' best losses after the round (Eq. 9)
  gloss   () the global model's loss   gbest  () its best (Eq. 10)
  pre_is_last  True where `pre` must equal the previous round's
          `losses`"""
from __future__ import annotations

import torch


def one_hot_argmin(theta: torch.Tensor) -> torch.Tensor:
    """Eq. 6's fallback: the single best score (the first on ties)."""
    out = torch.zeros_like(theta, dtype=torch.float32)
    out[torch.argmin(theta)] = 1.0
    return out


def select(theta: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """Eq. 6: every worker with theta <= the previous round's mean, else
    the single best."""
    mask = (theta <= threshold).to(torch.float32)
    return mask if bool(mask.any()) else one_hot_argmin(theta)


def flips(records: list, eta: torch.Tensor, tau: float) -> tuple[int, str]:
    """(the entries that differ from Eqs. 5-6 and 9-10 over the rounds,
    where they are); `eta` is the reference's own degrees."""
    total, where, prev = 0, [], None
    for r, x in enumerate(records):
        inf = torch.full_like(x["best"], float("inf"))
        best0 = inf if prev is None else prev["best"]
        gbest0 = inf[0] if prev is None else prev["gbest"]
        mean0 = inf[0] if prev is None else prev["mean"]
        bad = {"eta": x["eta"] != eta.to(x["eta"].device),
               "theta": tau * x["losses"] + (1.0 - tau) * x["eta"]
               != x["theta"],
               "mask": select(x["theta"], mean0) != x["mask"],
               "mean": x["theta"].mean() != x["mean"],
               "best": torch.where(x["pre"] < best0, x["pre"], best0)
               != x["best"],
               "gbest": torch.where(x["gloss"] < gbest0, x["gloss"], gbest0)
               != x["gbest"]}
        if x.get("pre_is_last") and prev is not None:
            bad["pre"] = x["pre"] != prev["losses"]
        for k, v in bad.items():
            n = int(v.sum())
            if n:
                total += n
                where.append(f"round {r + 1} {k} x{n}")
        prev = x
    return total, ", ".join(where)
