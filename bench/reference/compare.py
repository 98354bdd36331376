"""The numbers that decide `correct` for a training cell, from what the
timed path produced over its first rounds (a cell's `check.rounds`) and
what the plain reference produced from the same inputs:

  loss_gap    the largest relative gap between the program's and the
              reference's losses (the global model's and each worker's),
              over the rounds checked; `loss_gap_r1_global` the global
              model's after round 1 alone, `loss_gap_r1_mean` the mean
              gap of round 1's losses
  grad_gap    the first gradient as the optimizer got it, read from the
              state after round 1 (each worker's Eq.-8 velocity, which in
              round 1 is the clipped SGD progress): over the leaves, the
              largest gap between the program's norm and the reference's
  change_gap  the change of the state after the last checked round from
              its start (the workers' params, velocities and bests, the
              global model, its best, the wire's residuals): the same
              worst leaf
  decision_flips
              the entries of the program's scores, selections and bests
              that differ from Eqs. 5-6 and 9-10 applied to its own
              losses, its eta (held to the reference's) and its state
              before each round (reference/decisions.py); exact, limit 0

A cell compares the numbers its `check.limits` names; the others are
readings for calibrate.py.

A leaf's gap is |norm_p - norm_r| / max(norm_r, the median leaf's norm_r
in its group). Leaves whose reference gradient is under a thousandth of
the median leaf's move by round-off alone and are left out by that rule
(`movers`), as are groups whose every reference norm is 0.

Each side hands its readings as a `Readings`: each checked round's
record (reference/decisions.py), and for each group the per-leaf norms
(f64 floats, sorted-path order)."""
from __future__ import annotations

import math
import statistics
from typing import NamedTuple

import torch

from bench.reference import decisions


class Readings(NamedTuple):
    records: list         # per checked round (reference/decisions.py)
    first: list           # per-leaf norms of the round-1 velocity
    change: dict          # group -> per-leaf norms of the change

    @property
    def losses(self) -> list:
        """Per checked round, [global, worker 0, ...]."""
        return [[float(x["gloss"])] + [float(v) for v in x["losses"]]
                for x in self.records]

    def taken(self) -> list:
        """Per checked round, the decisions taken: the selection mask,
        which workers' bests (`wl`) and whether the global best (`wg`)
        were replaced, read from the bests against those before."""
        out, prev = [], None
        for x in self.records:
            best0 = (torch.full_like(x["best"], float("inf")) if prev is None
                     else prev["best"])
            gbest0 = (torch.full_like(x["gbest"], float("inf"))
                      if prev is None else prev["gbest"])
            out.append({"mask": x["mask"], "wl": x["best"] != best0,
                        "wg": x["gbest"] != gbest0})
            prev = x
        return out


def norms(values: list) -> list:
    return [float(torch.linalg.vector_norm(t.double())) for t in values]


def change(init: list, stacked: dict, single: dict, zero: dict) -> dict:
    """Per-leaf norms of each group's change from its start: `stacked`
    groups hold (W, ...) leaves that started at `init` broadcast,
    `single` groups leaves that started at `init`, `zero` groups leaves
    that started at 0 (each group a leaf list in sorted-path order)."""
    out = {k: norms([a - b[None] for a, b in zip(v, init)])
           for k, v in stacked.items()}
    out.update({k: norms([a - b for a, b in zip(v, init)])
                for k, v in single.items()})
    out.update({k: norms(v) for k, v in zero.items()})
    return out


def movers(first_ref: list) -> list:
    """Indices of the leaves whose reference gradient is at least a
    thousandth of the median leaf's."""
    med = statistics.median(first_ref)
    return [i for i, n in enumerate(first_ref) if n >= 1e-3 * med]


def _worst(prog: list, ref: list, keep: list) -> tuple[float, int]:
    med = statistics.median([ref[i] for i in keep])
    worst, where = 0.0, -1
    for i in keep:
        denom = max(ref[i], med)
        if denom == 0.0:
            continue
        gap = abs(prog[i] - ref[i]) / denom
        if not math.isfinite(gap):
            return math.inf, i
        if gap > worst:
            worst, where = gap, i
    return worst, where


def compare(prog: Readings, ref: Readings, paths: list, tau: float) -> dict:
    """{number: (value, where)} for every number the module defines;
    `tau` is Eq. 5's."""
    out = {}
    worst, where = 0.0, ""
    for r, (ps, rs) in enumerate(zip(prog.losses, ref.losses)):
        for j, (p, q) in enumerate(zip(ps, rs)):
            g = abs(p - q) / abs(q) if q else abs(p)
            g = g if math.isfinite(g) else math.inf
            if g >= worst:
                worst = g
                where = f"round {r + 1} " + ("global" if j == 0
                                            else f"worker {j - 1}")
    out["loss_gap"] = (worst, where)
    keep = movers(ref.first)
    g, i = _worst(prog.first, ref.first, keep)
    out["grad_gap"] = (g, paths[i] if i >= 0 else "")
    best, where = 0.0, ""
    for name in ref.change:
        if not any(ref.change[name][i] > 0 for i in keep):
            continue
        g, i = _worst(prog.change[name], ref.change[name], keep)
        if g > best or not where:
            best, where = g, f"{name}/{paths[i]}" if i >= 0 else name
    out["change_gap"] = (best, where)
    n, where = decisions.flips(prog.records, ref.records[0]["eta"], tau)
    out["decision_flips"] = (float(n), where)
    # readings that a cell compares where its limits name them (the
    # steadier ones where the three-round numbers swing, PERF.md)
    r1 = [abs(p - q) / abs(q) for p, q in zip(prog.losses[0], ref.losses[0])]
    out["loss_gap_r1_mean"] = (sum(r1) / len(r1), "round 1 mean")
    out["loss_gap_r1_global"] = (r1[0], "round 1 global")
    return out
