"""Named scenario presets — the single front door to the experiment grid.

Every paper figure, comm regime, and mesh smoke run is one named,
validated `ExperimentSpec` here — the JAX package's table, name for
name, so a scenario means the same run in both packages. Entry points (`launch/train.py
--scenario`, the benchmarks, the examples) look scenarios up instead of
re-assembling MdslConfig/CommConfig/partition plumbing by hand; sweeps
start from a preset and `override()` the axis they vary.

    >>> from repro_torch.experiments import get_scenario, override, run
    >>> spec = override(get_scenario("paper/fig3-noniid1"), "run.rounds=2")
    >>> result = run(spec)

Conventions: `paper/…` names reproduce a figure or table of the source
paper; bare names are comm/robustness regimes from the related work
(CB-DSL arXiv:2208.05578, analog M-DSL arXiv:2510.18152); `mesh/…`
names drive the production mesh path on a reduced assigned arch.
"""
from __future__ import annotations

import dataclasses

from repro_torch.comm.budget import CommConfig
from repro_torch.core.pso import PsoHyperParams
from repro_torch.experiments.spec import (AlgoSpec, DataSpec, ExperimentSpec,
                                    ModelSpec, PopulationSpec, RunSpec)

_SCENARIOS: dict[str, ExperimentSpec] = {}


def register_scenario(spec: ExperimentSpec) -> ExperimentSpec:
    """Add a named preset (validated; name collisions are an error)."""
    if not spec.name:
        raise ValueError("scenario specs must carry a name")
    if spec.name in _SCENARIOS:
        raise ValueError(f"scenario {spec.name!r} already registered")
    _SCENARIOS[spec.name] = spec.validate()
    return spec


def list_scenarios() -> list[str]:
    """All registered scenario names, sorted."""
    return sorted(_SCENARIOS)


def get_scenario(name: str) -> ExperimentSpec:
    """Look up a preset by name (specs are frozen — safe to share)."""
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; available: "
                         f"{', '.join(list_scenarios())}") from None


def describe_scenarios() -> list[tuple[str, str]]:
    """(name, one-line summary) rows for CLI/README tables."""
    rows = []
    for name in list_scenarios():
        s = _SCENARIOS[name]
        if s.model.kind == "paper":
            what = (f"{s.algo.algorithm}/{s.data.case}/{s.data.dataset} "
                    f"C={s.data.num_workers} R={s.run.rounds}")
        else:
            what = (f"{s.model.name} W={s.data.num_workers} "
                    f"steps={s.run.rounds}")
        if s.fleet.population:
            what = (f"{s.algo.algorithm}/{s.data.case}/{s.data.dataset} "
                    f"P={s.fleet.population} K={s.data.num_workers}"
                    f"/{s.fleet.cohort_policy} R={s.run.rounds}")
        wire = []
        if s.comm.compressor != "identity":
            wire.append(s.comm.compressor)
        if s.comm.downlink_compressor != "identity":
            wire.append(f"down:{s.comm.downlink_compressor}")
        if s.comm.channel != "ideal":
            wire.append(s.comm.channel)
        if s.comm.fading != "none":
            wire.append(f"{s.comm.fading}@{s.comm.doppler_rho}")
        if s.comm.outage_snr_db is not None:
            wire.append(f"outage>{s.comm.outage_snr_db:g}dB")
        if s.comm.byzantine:
            wire.append(f"byz={s.comm.byzantine}:{s.comm.aggregator}")
        if s.comm.adaptive_bits:
            wire.append(f"tiers={s.comm.num_tiers}:{s.comm.tier_rank}")
        if s.comm.round_deadline_s is not None:
            wire.append(f"ddl={s.comm.round_deadline_s:g}s"
                        f"/γ={s.comm.staleness_gamma:g}")
            if s.comm.quorum:
                wire.append(f"quorum={s.comm.quorum}")
        if s.comm.fault_prob:
            wire.append(f"faults={s.comm.fault_prob:g}"
                        f"x{s.comm.fault_rounds}r")
        rows.append((name, what + (f" [{' '.join(wire)}]" if wire else "")))
    return rows


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

# Paper §V-A settings: C=50, 5-layer CNN width x8, 4 local epochs,
# batch 64, lr 0.01 decayed, tau=0.9 — the Fig. 3 operating point.
_PAPER_HP = PsoHyperParams(learning_rate=0.01, velocity_clip=0.1)
_FIG3 = ExperimentSpec(
    data=DataSpec(dataset="mnist_like", num_workers=50, n_local=512),
    model=ModelSpec(kind="paper", name="cnn", width_mult=8),
    algo=AlgoSpec(algorithm="mdsl", tau=0.9, local_epochs=4, batch_size=64,
                  hp=_PAPER_HP),
    run=RunSpec(rounds=20),
)


def _fig3(name: str, **data_kw) -> ExperimentSpec:
    return dataclasses.replace(
        _FIG3, name=name, data=dataclasses.replace(_FIG3.data, **data_kw))


def _comm(name: str, comm: CommConfig) -> ExperimentSpec:
    return dataclasses.replace(_fig3(name, case="noniid1"), comm=comm)


# -- paper figures ----------------------------------------------------------
for _case in ("iid", "noniid1", "noniid2"):
    register_scenario(_fig3(f"paper/fig3-{_case}", case=_case))
register_scenario(_fig3("paper/fig3-cifar-noniid1", dataset="cifar_like",
                        case="noniid1"))

# -- robustness regimes (CB-DSL's Byzantine setting, arXiv:2208.05578) ------
register_scenario(dataclasses.replace(
    _comm("byzantine-median",
          CommConfig(byzantine=3, byzantine_mode="gaussian",
                     byzantine_scale=25.0, aggregator="median")),
    algo=dataclasses.replace(_FIG3.algo, algorithm="fedavg")))
register_scenario(dataclasses.replace(
    _comm("byzantine-trimmed",
          CommConfig(byzantine=3, byzantine_mode="gaussian",
                     byzantine_scale=25.0, aggregator="trimmed_mean",
                     trim_ratio=0.2)),
    algo=dataclasses.replace(_FIG3.algo, algorithm="fedavg")))

# -- comm regimes (channel-aware M-DSL, arXiv:2510.18152) -------------------
register_scenario(_comm("low-bandwidth-int4",
                        CommConfig(compressor="int4",
                                   downlink_compressor="int8")))
register_scenario(_comm("low-bandwidth-topk",
                        CommConfig(compressor="topk", topk_ratio=0.05)))
register_scenario(_comm("lossy-uplink-erasure",
                        CommConfig(channel="erasure", drop_prob=0.3)))
register_scenario(_comm("noisy-uplink-awgn",
                        CommConfig(channel="awgn", snr_db=10.0)))
register_scenario(_comm("adaptive-tiers",
                        CommConfig(compressor="int8", adaptive_bits=True)))

# -- physical-layer regimes (comm.phy: Rayleigh uplinks, SNR->rate) ---------
register_scenario(_comm("rayleigh-uplink",
                        CommConfig(channel="awgn", snr_db=10.0,
                                   fading="rayleigh", doppler_rho=0.9)))
register_scenario(_comm("rayleigh-outage",
                        CommConfig(channel="composite", drop_prob=0.05,
                                   snr_db=10.0, fading="rayleigh",
                                   doppler_rho=0.9, outage_snr_db=0.0)))
register_scenario(_comm("snr-tiered-bits",
                        CommConfig(channel="awgn", snr_db=15.0,
                                   fading="rayleigh", doppler_rho=0.9,
                                   adaptive_bits=True, num_tiers=3,
                                   tier_rank="snr")))
register_scenario(_comm("energy-budget",
                        CommConfig(channel="awgn", snr_db=5.0,
                                   fading="rayleigh", doppler_rho=0.8,
                                   compressor="int4", tx_power_w=0.2,
                                   bandwidth_hz=200e3,
                                   pathloss_spread_db=6.0)))

# -- straggler / deadline regimes (comm.straggler: FedBuff-style async) -----
# Deadlines calibrated against the fig3 C=50 width-8 model: its dense
# payload is ~113 KiB, i.e. ~0.16 s of airtime at the 20 dB / 1 MHz link
# budget — so 0.2 s makes the faded/far tail late while near workers
# stay on time (benchmarks/comm_efficiency.py sweeps this axis).
register_scenario(_comm("straggler/deadline-tight",
                        CommConfig(fading="rayleigh", doppler_rho=0.9,
                                   pathloss_spread_db=6.0,
                                   round_deadline_s=0.2,
                                   staleness_gamma=0.5, quorum=10)))
register_scenario(_comm("straggler/fedbuff",
                        CommConfig(fading="rayleigh", doppler_rho=0.9,
                                   round_deadline_s=0.25,
                                   staleness_gamma=1.0)))

# -- small teaching fleets (the examples) -----------------------------------
register_scenario(ExperimentSpec(
    name="quickstart",
    data=DataSpec(dataset="mnist_like", case="noniid1", num_workers=8,
                  n_local=256),
    model=ModelSpec(kind="paper", name="cnn", width_mult=2),
    algo=AlgoSpec(algorithm="mdsl", tau=0.9, local_epochs=1, batch_size=64,
                  hp=PsoHyperParams(learning_rate=0.01, velocity_clip=1.0)),
    run=RunSpec(rounds=4),
))
register_scenario(ExperimentSpec(
    name="edge-iot/noniid2",
    data=DataSpec(dataset="mnist_like", case="noniid2", num_workers=10,
                  n_local=256),
    model=ModelSpec(kind="paper", name="cnn", width_mult=2),
    algo=AlgoSpec(algorithm="mdsl", tau=0.9, local_epochs=1, batch_size=64,
                  hp=_PAPER_HP),
    run=RunSpec(rounds=8),
))

# -- sampled-cohort fleets (core/population: P registered, K active) --------
_FLEET = ExperimentSpec(
    data=DataSpec(dataset="mnist_like", case="noniid1", num_workers=16,
                  n_local=128),
    model=ModelSpec(kind="paper", name="cnn", width_mult=2),
    algo=AlgoSpec(algorithm="mdsl", tau=0.9, local_epochs=1, batch_size=64,
                  hp=_PAPER_HP),
    run=RunSpec(rounds=10),
)
register_scenario(dataclasses.replace(
    _FLEET, name="fleet/million-uniform",
    fleet=PopulationSpec(population=1_000_000, cohort_size=16,
                         cohort_policy="uniform")))
register_scenario(dataclasses.replace(
    _FLEET, name="fleet/million-score",
    fleet=PopulationSpec(population=1_000_000, cohort_size=16,
                         cohort_policy="score_weighted"),
    # Rayleigh fading so the O(K) lazy catch-up (rho^Δ closed form) is
    # exercised: resampled devices re-enter with compressed idle rounds
    comm=CommConfig(channel="awgn", snr_db=10.0, fading="rayleigh",
                    doppler_rho=0.9)))

# -- fault injection: deterministic worker churn (comm.straggler) -----------
# The fleet-scale robustness run: every round each of the 16 workers
# starts a 2-round outage with p=0.15, the ~21 ms deadline makes faded
# workers late (the w=2 payload is ~7.5 KiB: ~11 ms of airtime at the
# 20 dB budget), and the quorum holds w_t when churn + fades thin the
# round below 4 deltas. tests/test_straggler.py pins recovery.
register_scenario(dataclasses.replace(
    _FLEET, name="faults/churn",
    comm=CommConfig(fading="rayleigh", doppler_rho=0.9,
                    pathloss_spread_db=3.0, round_deadline_s=0.02,
                    staleness_gamma=0.5, quorum=4,
                    fault_prob=0.15, fault_rounds=2)))

# -- mesh smoke runs (production path, reduced archs) -----------------------
_MESH_HP = PsoHyperParams(learning_rate=3e-3, velocity_clip=1.0)
for _arch in ("smollm-360m", "xlstm-350m"):
    register_scenario(ExperimentSpec(
        name=f"mesh/{_arch.split('-')[0]}-smoke",
        data=DataSpec(num_workers=2),
        model=ModelSpec(kind="mesh", name=_arch, reduced=True, seq_len=128,
                        per_worker_batch=2),
        algo=AlgoSpec(algorithm="mdsl", tau=0.9, local_steps=1, hp=_MESH_HP),
        run=RunSpec(rounds=5),
    ))
