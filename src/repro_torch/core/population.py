"""Million-device fleets with O(K) round state (the JAX package's
`core/population.py`).

A population of P registered devices, of which a cohort of K is active
each round:

  PopulationTable  per-device scalars over P, struct of arrays: the
                   physical-layer state (fading gains, pathloss slot,
                   last-known SNR, delivery age), the EF-residual norm,
                   the last Eq.-5 score and the last-seen / last-evolved
                   round markers. Nine (P,) vectors, 36 bytes a device,
                   never an O(P) model pytree.
  sample_cohort    a K-subset by Gumbel-top-k (top K of logits plus
                   i.i.d. Gumbel noise is an exact draw without
                   replacement) under three policies: `uniform`,
                   `score_weighted` (low last theta preferred) and
                   `snr_aware` (high last-known SNR preferred).
  gather_phy       cohort rows -> a K-slot PhyState, with the idle rounds
                   caught up in one closed-form fading draw
                   (`phy.lazy_fading_coeffs`); O(K) whatever P is.
  scatter_round    the cohort's post-round state back into the table.

Random draws are inputs: `sample_cohort` takes the (P,) Gumbel noise and
`gather_phy` the (K, 2) catch-up normals; `population_draws` makes both
from the population's own generator, apart from the engine's round
draws. P == K under the uniform policy returns the identity cohort with
no draw, and its lag-0 rows pass through `torch.where` untouched, so
such runs are bit-identical to the unwrapped engine.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.comm import phy as comm_phy
from repro_torch.comm.budget import CommConfig
from repro_torch.comm.phy import PhyState
from repro_torch.pytree import tree_leaves

POP_SALT = 0xC0   # the population's stream, apart from the engine's draws

COHORT_POLICIES = ("uniform", "score_weighted", "snr_aware")

_SNR_TEMP_DB = 10.0   # snr_aware softness: +10 dB last-known SNR ~ e x odds


class PopulationTable(NamedTuple):
    """Struct-of-arrays registry of P devices, O(P) scalars only.

    `phy` is a population-sized PhyState (pathloss is the device's static
    slot in the P-wide profile; h / snr / age its last participating
    state); `score` the last Eq.-5 theta; `ef_norm` the L2 norm of its
    uplink EF residual when it left the cohort; `last_seen` /
    `last_evolved` round indices (-1 = never)."""
    phy: PhyState              # five (P,) columns
    ef_norm: torch.Tensor      # (P,) f32
    score: torch.Tensor        # (P,) f32
    last_seen: torch.Tensor    # (P,) int32
    last_evolved: torch.Tensor  # (P,) int32


class PopulationDraws(NamedTuple):
    """One round's population draws."""
    gumbel: Optional[torch.Tensor]   # (P,) Gumbel noise (None: no draw)
    normals: Optional[torch.Tensor]  # (K, 2) catch-up normals (None: no
    #                                  fading)


def init_table(comm: CommConfig, population: int,
               device=None) -> PopulationTable:
    """Unit-gain channels over the P-wide pathloss profile (the engines'
    `phy.init_state`), zero scores and norms, nothing seen yet."""
    z = torch.zeros((population,), dtype=torch.float32, device=device)
    neg1 = torch.full((population,), -1, dtype=torch.int32, device=device)
    return PopulationTable(phy=comm_phy.init_state(comm, population, device),
                           ef_norm=z, score=z.clone(), last_seen=neg1,
                           last_evolved=neg1.clone())


def table_specs(population: int) -> PopulationTable:
    """Meta-device stand-ins for one table (the mesh path prices and
    places a P-device registry without allocating P-sized buffers)."""
    f32 = lambda: torch.empty((population,), dtype=torch.float32,
                              device="meta")
    i32 = lambda: torch.empty((population,), dtype=torch.int32,
                              device="meta")
    return PopulationTable(
        phy=PhyState(h_re=f32(), h_im=f32(), pathloss_db=f32(),
                     snr_db=f32(), age=i32()),
        ef_norm=f32(), score=f32(), last_seen=i32(), last_evolved=i32())


def table_bytes(table: PopulationTable) -> int:
    """The registry's footprint in bytes."""
    return int(sum(x.numel() * x.element_size()
                   for x in tree_leaves(table)))


# ---------------------------------------------------------------------------
# cohort sampling
# ---------------------------------------------------------------------------

def _policy_logits(table: PopulationTable, policy: str) -> torch.Tensor:
    """Per-device selection logits from the table's last-known state."""
    if policy == "uniform":
        return torch.zeros_like(table.score)
    if policy == "score_weighted":
        # lower theta = better -> higher logit, standardized over the seen
        # devices; never-seen devices sit at the mean (round 0: uniform)
        seen = (table.last_seen >= 0).to(torch.float32)
        n = torch.clamp(seen.sum(), min=1.0)
        mean = (table.score * seen).sum() / n
        var = (((table.score - mean) ** 2) * seen).sum() / n
        z = (table.score - mean) / (torch.sqrt(var) + 1e-6)
        return torch.where(seen > 0, -z, torch.zeros_like(z))
    if policy == "snr_aware":
        return table.phy.snr_db / _SNR_TEMP_DB
    raise ValueError(f"unknown cohort policy {policy!r} "
                     f"(choose from {COHORT_POLICIES})")


def needs_gumbel(population: int, cohort_size: int, policy: str) -> bool:
    """Does sampling a cohort take Gumbel noise? Not in the full-fleet
    case (P == K, uniform), which seats the identity cohort."""
    return not (policy == "uniform" and population == cohort_size)


def sample_cohort(table: PopulationTable, cohort_size: int, policy: str,
                  gumbel: Optional[torch.Tensor]) -> torch.Tensor:
    """K distinct device ids, in descending order of logit + Gumbel noise
    (the slot order the reseat compares against)."""
    P = table.score.shape[0]
    if not needs_gumbel(P, cohort_size, policy):
        return torch.arange(cohort_size, dtype=torch.int32,
                            device=table.score.device)
    noisy = _policy_logits(table, policy) + gumbel
    return torch.topk(noisy, cohort_size, sorted=True).indices.to(
        torch.int32)


# ---------------------------------------------------------------------------
# gather (with lazy catch-up) / scatter
# ---------------------------------------------------------------------------

def gather_phy(comm: CommConfig, table: PopulationTable, idx: torch.Tensor,
               round_idx: int, normals: Optional[torch.Tensor]) -> PhyState:
    """Cohort rows -> the K-slot PhyState entering round `round_idx`.

    A stored row was refreshed by round `last_evolved`'s evolution; the
    lag = t - 1 - last_evolved idle rounds since collapse into one draw,
    h <- rho^lag h + sqrt(1 - rho^(2 lag)) CN(0, 1), from `normals` (K,
    2); the delivery age advances by the idle-round count. lag-0 rows
    pass through bitwise."""
    li = idx.long()
    p = PhyState(*(col[li] for col in table.phy))
    age = p.age + (round_idx - 1 - table.last_seen[li])
    if comm.fading == "none":
        return p._replace(age=age)
    lag = round_idx - 1 - table.last_evolved[li]
    rho_d, innov = comm_phy.lazy_fading_coeffs(comm, lag)
    std = torch.sqrt(torch.tensor(0.5, dtype=torch.float32,
                                  device=idx.device))
    h_re = rho_d * p.h_re + innov * std * normals[:, 0]
    h_im = rho_d * p.h_im + innov * std * normals[:, 1]
    fresh = lag > 0
    h_re = torch.where(fresh, h_re, p.h_re)
    h_im = torch.where(fresh, h_im, p.h_im)
    snr = torch.where(fresh, comm_phy.instantaneous_snr_db(
        comm, h_re, h_im, p.pathloss_db), p.snr_db)
    return PhyState(h_re=h_re, h_im=h_im, pathloss_db=p.pathloss_db,
                    snr_db=snr, age=age)


def population_draws(gen: torch.Generator, comm: CommConfig,
                     population: int, cohort_size: int, policy: str,
                     device) -> PopulationDraws:
    """One round's population draws from the population's generator."""
    gumbel = normals = None
    if needs_gumbel(population, cohort_size, policy):
        u = torch.rand((population,), generator=gen, device=device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    if comm.fading != "none":
        normals = torch.randn((cohort_size, 2), generator=gen, device=device)
    return PopulationDraws(gumbel=gumbel, normals=normals)


def schedule(table: PopulationTable, round_idx: int, draws: PopulationDraws,
             *, comm: CommConfig, cohort_size: int, policy: str
             ) -> tuple[torch.Tensor, PhyState]:
    """One round of population scheduling: sample the K-cohort, gather
    its channel rows with lazy catch-up. Returns (device ids, PhyState
    for the engine's worker axis)."""
    idx = sample_cohort(table, cohort_size, policy, draws.gumbel)
    return idx, gather_phy(comm, table, idx, round_idx, draws.normals)


def residual_norms(residual) -> torch.Tensor:
    """(K,) L2 norms of the stacked uplink EF residual."""
    total = None
    for x in tree_leaves(residual):
        sq = (x.to(torch.float32) ** 2).sum(dim=tuple(range(1, x.ndim)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def scatter_round(table: PopulationTable, idx: torch.Tensor, phy: PhyState,
                  theta: torch.Tensor, ef_norm: torch.Tensor,
                  round_idx: int) -> PopulationTable:
    """Write the cohort's post-round state back (out of place): the
    channel rows, the round's scores, the EF-residual norms and both
    round markers. Pathloss is static and never rewritten; the cohort's
    ids are distinct."""
    li = idx.long()
    stamp = torch.full(idx.shape, round_idx, dtype=torch.int32,
                       device=idx.device)

    def up(col, v):
        return col.index_put((li,), v.to(col.dtype))

    return PopulationTable(
        phy=PhyState(h_re=up(table.phy.h_re, phy.h_re),
                     h_im=up(table.phy.h_im, phy.h_im),
                     pathloss_db=table.phy.pathloss_db,
                     snr_db=up(table.phy.snr_db, phy.snr_db),
                     age=up(table.phy.age, phy.age)),
        ef_norm=up(table.ef_norm, ef_norm),
        score=up(table.score, theta),
        last_seen=up(table.last_seen, stamp),
        last_evolved=up(table.last_evolved, stamp))
