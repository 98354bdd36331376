"""One M-DSL round of the mesh engine over W transformer workers, in
plain PyTorch (bfloat16 weights, as the configuration states):

  LocalUpdate   each worker's local SGD steps on its own batch, the step
                formed in f32 and rounded once to bf16 (d = that step's
                bf16 result - w); then Eq. 8 with its rounding points:
                w^l - w, w^g - w and d in bf16, the velocity summed in
                f32 left to right and clipped, v' rounded to bf16, w' =
                bf16(w + v'); then every worker's loss on the eval batch
  ScoreSelect   Eq. 5 (tau, eta = 0) and Eq. 6
  Wire          an ideal channel, no compression: Eq. 7's masked mean of
                the deltas formed in f32, added to w_t and rounded to bf16
  BestTracking  Eqs. 9-10 on the workers' and the global model's losses

The state is a dict of stacked (W, ...) trees and the global trees."""
from __future__ import annotations

import torch

from bench.reference import decisions, transformer
from bench.reference.paper_round import lr_at
from bench.reference.tree import leaves, like, tmap

F32 = torch.float32


def init_state(params: dict, W: int) -> dict:
    stacked = tmap(lambda x: x.expand((W,) + tuple(x.shape)).clone(), params)
    dev = leaves(params)[0].device
    inf = torch.tensor(float("inf"), device=dev)
    return {"w": stacked, "v": tmap(torch.zeros_like, stacked),
            "wl": stacked, "wl_loss": torch.full((W,), float("inf"),
                                                 device=dev),
            "g": params, "wg": params, "wg_loss": inf,
            "theta_mean": inf.clone()}


def _worker(tree: dict, i: int) -> dict:
    return tmap(lambda x: x[i], tree)


def round_(state: dict, batch: dict, eval_batch: dict, coeffs: torch.Tensor,
           t: int, cfg: dict, hp: dict, precision: str = "bf16",
           fault: str = "", hints: dict | None = None) -> tuple[dict, dict]:
    """One round; returns (next state, the round's record), `hints` and
    `fault` as in reference/paper_round ("half_batch": half of each
    worker's batch left out of its step)."""
    hints = hints or {}
    W = coeffs.shape[0]
    lr = lr_at(hp, t)
    rows = hp["ref_rows"]
    d = []
    for i in range(W):
        w0 = _worker(state["w"], i)
        p = w0
        toks, labs = batch["tokens"][i], batch["labels"][i]
        if fault == "half_batch":
            toks, labs = toks[:toks.shape[0] // 2], labs[:labs.shape[0] // 2]
        for _ in range(hp.get("local_steps", 1)):
            _, g = transformer.loss_grads(p, toks, labs, cfg, precision, rows)
            p = like(p, [(a.to(F32) - lr * b).to(a.dtype)
                         for a, b in zip(leaves(p), g)])
            del g
        d.append(tmap(torch.sub, p, w0))
        del p
    dstack = tmap(lambda *xs: torch.stack(xs), *d)
    del d
    c = coeffs.to(F32)
    clip = hp["velocity_clip"]

    def eq8(w, v, l, g, dd):
        b = (-1,) + (1,) * (w.ndim - 1)
        vn = c[:, 0].reshape(b) * v.to(F32)
        vn = vn + c[:, 1].reshape(b) * (l - w).to(F32)
        vn = vn + c[:, 2].reshape(b) * (g[None] - w).to(F32)
        vn = vn + dd.to(F32)
        if clip > 0:
            vn = vn.clamp(-clip, clip)
        vo = vn.to(w.dtype)
        return torch.stack([(w.to(F32) + vo.to(F32)).to(w.dtype), vo])
    both = tmap(eq8, state["w"], state["v"], state["wl"], state["wg"], dstack)
    del dstack
    w = tmap(lambda x: x[0], both)
    v = tmap(lambda x: x[1], both)
    del both
    losses = torch.stack([
        transformer.loss(_worker(w, i), eval_batch["tokens"],
                         eval_batch["labels"], cfg, precision, rows)
        for i in range(W)])
    eta = torch.zeros_like(losses)
    theta = hp["tau"] * losses + (1.0 - hp["tau"]) * eta
    mask = hints.get("mask", decisions.select(theta, state["theta_mean"]))
    if fault == "select_all":
        mask = torch.ones_like(theta)
    denom = torch.clamp(mask.sum(), min=1.0)

    def agg(gl, wn, wo):
        dl = (wn - wo).to(F32)
        s = (mask.reshape((-1,) + (1,) * (dl.ndim - 1)) * dl).sum(0)
        return (gl + s / denom).to(gl.dtype)
    g = tmap(agg, state["g"], w, state["w"])
    gloss = transformer.loss(g, eval_batch["tokens"], eval_batch["labels"],
                             cfg, precision, rows)
    better = hints.get("wl", losses < state["wl_loss"])
    take = hints.get("wg", gloss < state["wg_loss"])
    nxt = dict(state, w=w, v=v,
               wl=tmap(lambda n, o: torch.where(
                   better.reshape((-1,) + (1,) * (n.ndim - 1)), n, o),
                   w, state["wl"]),
               wl_loss=torch.where(better, losses, state["wl_loss"]),
               g=g, wg=tmap(lambda n, o: torch.where(take, n, o), g,
                            state["wg"]),
               wg_loss=torch.where(take, gloss, state["wg_loss"]),
               theta_mean=theta.mean())
    return nxt, {"losses": losses, "theta": theta, "mask": mask,
                 "mean": nxt["theta_mean"], "eta": eta, "pre": losses,
                 "best": nxt["wl_loss"], "gloss": gloss,
                 "gbest": nxt["wg_loss"]}
