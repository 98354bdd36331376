"""One M-DSL round of the paper engine (Algorithm 1) over C workers, in
plain PyTorch and float32:

  LocalUpdate   Eq. 9 (each worker's best params by its Eq.-3 loss on
                D_g), E epochs of minibatch SGD through the CNN, Eq. 8
                once: v' = clip(c0 v + c1 (w^l - w) + c2 (w^g - w) + d),
                w' = w + v', d the round's SGD progress
  ScoreSelect   Eq. 5 theta = tau F + (1 - tau) eta; Eq. 6 selects
                theta <= the previous round's mean theta (everyone in
                round 0), else the single best
  Wire          the int-b uplink with error feedback, the Eq.-7 masked
                mean, the quantized downlink with the PS's error feedback
  BestTracking  Eq. 10 on the global model's Eq.-3 loss

The state is a dict of trees and tensors (see `init_state`); `draws` the
round's coefficients (C, 3), epoch permutations (C, E, n) and wire seeds
(C, L) and (L,)."""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import cnn5, decisions, wire
from bench.reference.tree import leaves, like, tmap


def eta(labels: torch.Tensor, global_labels: torch.Tensor, classes: int,
        coeffs: tuple) -> torch.Tensor:
    """Eq. 2 as a degree: 1 - minmax(beta1 |L_i|/|L_g| + beta2 W_i + phi),
    W_i the 1-D Wasserstein distance between worker i's label marginal
    and D_g's."""
    b1, b2, phi = coeffs
    ghist = torch.bincount(global_labels, minlength=classes).to(torch.float32)
    q = ghist / ghist.sum()
    raw = []
    for lab in labels:
        hist = torch.bincount(lab, minlength=classes).to(torch.float32)
        p = hist / hist.sum()
        ratio = (((hist > 0) & (ghist > 0)).sum().to(torch.float32)
                 / torch.clamp((ghist > 0).sum().to(torch.float32), min=1.0))
        wd = (torch.cumsum(p, 0) - torch.cumsum(q, 0)).abs().sum()
        raw.append(b1 * ratio + b2 * wd + phi)
    raw = torch.stack(raw)
    lo, hi = raw.min(), raw.max()
    return 1.0 - (raw - lo) / torch.clamp(hi - lo, min=1e-12)


def init_state(params: dict, C: int, eta_: torch.Tensor) -> dict:
    stacked = tmap(lambda x: x.expand((C,) + tuple(x.shape)).clone(), params)
    inf = torch.full((C,), float("inf"), device=eta_.device)
    return {"w": stacked, "v": tmap(torch.zeros_like, stacked),
            "wl": stacked, "wl_loss": inf,
            "g": params, "wg": params,
            "wg_loss": torch.tensor(float("inf"), device=eta_.device),
            "theta_mean": torch.tensor(float("inf"), device=eta_.device),
            "eta": eta_,
            "residual": tmap(torch.zeros_like, stacked),
            "ps_residual": tmap(torch.zeros_like, params)}


def lr_at(hp: dict, t: int) -> float:
    """alpha_init * gamma^(t // k) in float32 (paper §V-A)."""
    e = np.float32(t // hp["lr_decay_every"])
    return float(np.float32(hp["learning_rate"])
                 * np.float32(np.float32(hp["lr_decay"]) ** e))


def local_sgd(w: dict, x: torch.Tensor, y: torch.Tensor, perms: torch.Tensor,
              lr: float, bs: int, half_batch: bool = False) -> dict:
    """E epochs of minibatch SGD for every worker (perms (C, E, n)).
    `half_batch` is a planted fault: half of each minibatch left out."""
    C, n = x.shape[:2]
    bs = min(bs, n)
    rows = torch.arange(C, device=x.device)[:, None]
    for e in range(perms.shape[1]):
        idx = perms[:, e, :(n // bs) * bs]
        xe, ye = x[rows, idx], y[rows, idx]
        for s in range(n // bs):
            sl = slice(s * bs, s * bs + (bs // 2 if half_batch else bs))
            g = cnn5.grads(w, xe[:, sl], ye[:, sl])
            w = tmap(lambda a, b: a - lr * b, w, g)
    return w


def round_(state: dict, data: dict, draws: dict, t: int, hp: dict,
           fault: str = "", hints: dict | None = None) -> tuple[dict, dict]:
    """One round from `state`; returns (next state, the round's record
    as reference/decisions.py reads it). The decisions (Eq. 9's
    replaced bests `wl`, Eq. 6's `mask`, Eq. 10's `wg`) are the
    reference's own, or the program's where `hints` gives them: those
    the decision check judged by the program's numbers, which round-off
    lets two sound runs take otherwise. `fault` plants one:
    "half_batch" leaves half of each minibatch out, "select_all"
    selects every worker."""
    hints = hints or {}
    x, y, gx, gy = data["x"], data["y"], data["gx"], data["gy"]
    lr = lr_at(hp, t)
    # Eq. 9 on the round's starting params
    pre = cnn5.score(state["w"], gx, gy)
    better = hints.get("wl", pre < state["wl_loss"])
    wl = tmap(lambda n, o: torch.where(
        better.reshape((-1,) + (1,) * (n.ndim - 1)), n, o), state["w"],
        state["wl"])
    wl_loss = torch.where(better, pre, state["wl_loss"])
    w0 = state["w"]
    trained = local_sgd(w0, x, y, draws["perms"], lr, hp["batch_size"],
                        fault == "half_batch")
    c = draws["coeffs"]

    def eq8(w, v, l, g, tr):
        b = (-1,) + (1,) * (w.ndim - 1)
        vn = (c[:, 0].reshape(b) * v + c[:, 1].reshape(b) * (l - w)
              + c[:, 2].reshape(b) * (g[None] - w) + (tr - w))
        clip = hp["velocity_clip"]
        return vn.clamp(-clip, clip) if clip > 0 else vn
    v = tmap(eq8, w0, state["v"], wl, state["wg"], trained)
    w = tmap(torch.add, w0, v)
    losses = cnn5.score(w, gx, gy)
    theta = hp["tau"] * losses + (1.0 - hp["tau"]) * state["eta"]
    mask = hints.get("mask", decisions.select(theta, state["theta_mean"]))
    if fault == "select_all":
        mask = torch.ones_like(theta)
    delta = leaves(tmap(torch.sub, w, w0))
    sent, residual = wire.uplink(delta, leaves(state["residual"]), mask,
                                 draws["up_seeds"], hp["uplink_bits"])
    agg = wire.aggregate(leaves(state["g"]), sent, mask)
    g, ps_res = wire.downlink(agg, leaves(state["g"]),
                              leaves(state["ps_residual"]),
                              draws["down_seeds"], hp["downlink_bits"])
    g = like(state["g"], g)
    gloss = cnn5.score(tmap(lambda a: a[None], g), gx, gy)[0]
    take = hints.get("wg", gloss < state["wg_loss"])
    nxt = dict(state, w=w, v=v, wl=wl, wl_loss=wl_loss, g=g,
               wg=tmap(lambda n, o: torch.where(take, n, o), g, state["wg"]),
               wg_loss=torch.where(take, gloss, state["wg_loss"]),
               theta_mean=theta.mean(),
               residual=like(state["residual"], residual),
               ps_residual=like(state["ps_residual"], ps_res))
    return nxt, {"losses": losses, "theta": theta, "mask": mask,
                 "mean": nxt["theta_mean"], "eta": state["eta"], "pre": pre,
                 "best": wl_loss, "gloss": gloss, "gbest": nxt["wg_loss"],
                 "pre_is_last": True}
