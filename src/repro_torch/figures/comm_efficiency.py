"""Paper §IV-C on the port: communication efficiency, in bytes on the
wire (the counterpart of the JAX package's
`benchmarks/comm_efficiency.py`).

FedAvg uploads C dense models per round; M-DSL uploads only the Eq.-6
selected subset — and with `repro_torch.comm` the payload itself shrinks
(top-k / int8 / int4 with error feedback), the downlink broadcast can
be quantized with PS-side error feedback, and the PS can assign wire
tiers per worker from the Eq.-5 rank. This benchmark is a thin client
of the scenario registry: the base spec is `paper/fig3-noniid1`, and
every swept axis (algorithm, compressor, aggregator, attack) is a
dotted-path override. It reports accuracy-vs-total-bytes (up + down)
trade-off curves, plus a Byzantine sweep showing where median /
trimmed-mean aggregation retains accuracy while the masked mean
degrades.

`--json` additionally runs the straggler sweep — accuracy vs
`round_deadline_s` x staleness-gamma, FedAvg vs M-DSL selection, plus a
quorum-gated cell — and writes artifacts/BENCH_stragglers__torch.json
(the reference's BENCH_stragglers.json schema): the graceful-degradation
claim of the deadline engine (comm.straggler), with numbers.

Usage:
  python -m repro_torch.figures.comm_efficiency --aggregator median \\
      --downlink-compressor int8
  python -m repro_torch.figures.comm_efficiency --full --byzantine 3
  python -m repro_torch.figures.comm_efficiency --quick --json [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.comm import AGGREGATORS, COMPRESSORS
from repro_torch.experiments import ExperimentSpec, get_scenario, override
from repro_torch.experiments import run as run_spec
from repro_torch.figures.common import print_table, save_record, write_json
from repro_torch.kernels.runtime import resolve_device
from repro_torch.obs.events import NULL, Emitter, new_run_id
from repro_torch.obs.sinks import JsonlSink, default_obs_dir

# benchmark-level obs stream (--obs): one SweepEvent per swept cell with
# the accuracy/bytes/energy cumulants, so the §IV-C tables — including
# accuracy-per-joule — are derivable from event streams alone. Each cell
# run additionally writes its own per-round stream.
_EM = NULL


def _obs_enable(tag: str) -> None:
    global _EM
    rid = new_run_id(f"bench__comm_efficiency__{tag}")
    _EM = Emitter(rid, JsonlSink(default_obs_dir() / f"{rid}.jsonl"))

SWEEP = [
    ("identity", ("comm.compressor=identity",)),
    ("topk5%", ("comm.compressor=topk", "comm.topk_ratio=0.05")),
    ("int8", ("comm.compressor=int8",)),
    ("int4", ("comm.compressor=int4",)),
]

# accuracy-vs-energy axis (comm.phy): Rayleigh uplinks at 10 dB mean
# SNR, with/without SNR outage, and the channel-aware N=3 bit tiers
# ranked by instantaneous SNR (good channels earn more bits) — vs the
# same tiers ranked by the Eq.-5 score, blind to the channel.
_RAYLEIGH = ("comm.channel=awgn", "comm.snr_db=10.0",
             "comm.fading=rayleigh", "comm.doppler_rho=0.9")
PHY_SWEEP = [
    ("ideal", ()),
    ("rayleigh", _RAYLEIGH),
    ("rayleigh+outage", _RAYLEIGH + ("comm.channel=composite",
                                     "comm.drop_prob=0.05",
                                     "comm.outage_snr_db=0.0")),
    ("snr-tiers(3)", _RAYLEIGH + ("comm.adaptive_bits=true",
                                  "comm.num_tiers=3",
                                  "comm.tier_rank=snr")),
    ("score-tiers(3)", _RAYLEIGH + ("comm.adaptive_bits=true",
                                    "comm.num_tiers=3",
                                    "comm.tier_rank=score")),
]

QUICK = ("run.rounds=8", "model.width_mult=2", "data.num_workers=10",
         "data.n_local=256", "algo.hp.learning_rate=0.05")

# straggler grid (comm.straggler): deadlines bracket the quick model's
# ~24 ms airtime at the Rayleigh 10 dB budget (loose / binding / tight),
# gammas span drain-at-full-weight vs 1/(1+age) FedBuff discounting
STRAGGLER_DEADLINES = (0.05, 0.025, 0.015)
STRAGGLER_GAMMAS = (0.0, 1.0)


def rounds_to(acc_curve: list[float], target: float) -> int | None:
    for i, a in enumerate(acc_curve):
        if a >= target:
            return i + 1
    return None


def bytes_to(acc_curve: list[float], bytes_total: list[float],
             target: float) -> float | None:
    total = 0.0
    for a, b in zip(acc_curve, bytes_total):
        total += b
        if a >= target:
            return total
    return None


def base_spec(*, quick: bool, dataset: str, seed: int, aggregator: str,
              downlink_compressor: str, adaptive_bits: bool
              ) -> ExperimentSpec:
    spec = get_scenario("paper/fig3-noniid1")
    if quick:
        spec = override(spec, *QUICK)
    return override(spec, "algo.local_epochs=2",
                    f"data.dataset={dataset}", f"run.seed={seed}",
                    f"comm.aggregator={aggregator}",
                    f"comm.downlink_compressor={downlink_compressor}",
                    f"comm.adaptive_bits={adaptive_bits}").validate()


def _run_one(spec: ExperimentSpec, *overrides: str, cell: str = "cell",
             device=None) -> dict:
    sp = override(spec, *overrides) if overrides else spec
    if _EM.active:
        sp = override(sp, "run.obs.enabled=true")
    res = run_spec(sp, verbose=False, device=device)
    r = res.record
    r["total_bytes"] = r["total_bytes_up"] + r["total_bytes_down"]
    r["bytes_total"] = [u + d for u, d in zip(r["bytes_up"],
                                              r["bytes_down"])]
    _EM.sweep_cell(cell, seed=sp.run.seed, final=r["final_acc"],
                   events=res.events_path,
                   metrics={"final_acc": r["final_acc"],
                            "best_acc": r["best_acc"],
                            "total_bytes": r["total_bytes"],
                            "total_bytes_up": r["total_bytes_up"],
                            "total_bytes_down": r["total_bytes_down"],
                            "total_airtime_s": r["total_airtime_s"],
                            "total_energy_j": r["total_energy_j"]})
    return r


def byzantine_sweep(spec: ExperimentSpec, byzantine: int,
                    device=None) -> dict:
    """Robust-aggregation comparison under attack: FedAvg (every worker
    aggregated — the worst-case exposure) with `byzantine` adversarial
    workers, across Eq.-7 aggregators. Selection-based M-DSL is the
    paper's defense; median / trimmed mean are the aggregation-level
    defense that also protects the no-selection baseline."""
    workers = spec.data.num_workers
    # a trimmed mean only tolerates what it trims: cut at least the
    # attacked fraction from each end
    trim = min(max(spec.comm.trim_ratio, byzantine / workers), 0.45)
    attack = override(spec, f"comm.byzantine={byzantine}",
                      "comm.byzantine_mode=gaussian",
                      "comm.byzantine_scale=25.0",
                      f"comm.trim_ratio={trim}")
    out = {"byzantine": byzantine, "attack": attack.comm._asdict(),
           "runs": {}}
    rows = []
    for agg in AGGREGATORS:
        r = _run_one(attack, "algo.algorithm=fedavg",
                     f"comm.aggregator={agg}",
                     cell=f"byz{byzantine}/fedavg+{agg}", device=device)
        out["runs"][agg] = {"final_acc": r["final_acc"],
                            "best_acc": r["best_acc"], "acc": r["acc"],
                            "total_bytes": r["total_bytes"]}
        rows.append([f"fedavg+{agg}", f"{r['final_acc']:.3f}",
                     f"{r['best_acc']:.3f}",
                     f"{r['total_bytes'] / 2**20:.2f}MiB"])
    # the paper's selection defense, for reference: plain-mean Eq. 7 so
    # the row isolates selection (not selection + robust aggregation)
    r = _run_one(attack, "algo.algorithm=mdsl", "comm.aggregator=mean",
                 cell=f"byz{byzantine}/mdsl+mean", device=device)
    out["runs"]["mdsl_selection"] = {"final_acc": r["final_acc"],
                                     "best_acc": r["best_acc"],
                                     "acc": r["acc"],
                                     "total_bytes": r["total_bytes"]}
    rows.append(["mdsl+mean(sel.)", f"{r['final_acc']:.3f}",
                 f"{r['best_acc']:.3f}",
                 f"{r['total_bytes'] / 2**20:.2f}MiB"])
    print_table(["defense", "final_acc", "best_acc", "total bytes"], rows,
                f"Byzantine sweep ({byzantine} gaussian attackers)")
    return out


def phy_sweep(spec: ExperimentSpec, device=None) -> dict:
    """Accuracy-vs-energy over the physical-layer regimes: every run
    reports its SNR->rate airtime and transmit energy (comm.phy), so
    the table prices accuracy per joule — including the channel-aware
    N=3 SNR-ranked bit tiers against their channel-blind score-ranked
    twin."""
    out = {}
    rows = []
    for name, ovr in PHY_SWEEP:
        r = _run_one(spec, "algo.algorithm=mdsl", *ovr,
                     cell=f"phy/{name}", device=device)
        out[name] = {
            "final_acc": r["final_acc"], "best_acc": r["best_acc"],
            "acc": r["acc"], "total_bytes": r["total_bytes"],
            "total_airtime_s": r["total_airtime_s"],
            "total_energy_j": r["total_energy_j"],
            "mean_snr_db": r["mean_snr_db"], "delivered": r["delivered"]}
        eff = r["final_acc"] / max(r["total_energy_j"], 1e-12)
        rows.append([name, f"{r['final_acc']:.3f}",
                     f"{r['total_bytes'] / 2**20:.2f}MiB",
                     f"{r['total_airtime_s']:.3f}s",
                     f"{r['total_energy_j']:.3f}J",
                     f"{eff:.2f}"])
    print_table(["phy regime", "final_acc", "total bytes", "airtime",
                 "energy", "acc/J"], rows,
                "accuracy vs energy (Rayleigh uplink, SNR->rate airtime)")
    return out


def straggler_sweep(spec: ExperimentSpec,
                    algorithms: tuple[str, ...] = ("fedavg", "mdsl"),
                    device=None) -> dict:
    """Accuracy vs round deadline x staleness-gamma on a heterogeneous
    Rayleigh uplink (pathloss spread + fading make the slow tail late),
    FedAvg vs M-DSL selection, plus one quorum-gated cell. A tighter
    deadline parks more uploads; gamma prices how much a drained stale
    delta still counts — the table shows where buffering holds accuracy
    against simply losing the late uploads."""
    base = override(spec, *_RAYLEIGH, "comm.pathloss_spread_db=6.0")
    out = {"deadlines_s": list(STRAGGLER_DEADLINES),
           "gammas": list(STRAGGLER_GAMMAS), "runs": {}}
    rows = []

    def cell(algo: str, name: str, *ovr: str) -> None:
        r = _run_one(base, f"algo.algorithm={algo}", *ovr,
                     cell=f"straggler/{name}", device=device)
        late = sum(r.get("late", []))
        drained = sum(r.get("drained", []))
        holds = sum(r.get("held", []))
        out["runs"][name] = {
            "final_acc": r["final_acc"], "best_acc": r["best_acc"],
            "acc": r["acc"], "total_bytes": r["total_bytes"],
            "total_airtime_s": r["total_airtime_s"],
            "late": r.get("late"), "drained": r.get("drained"),
            "buffered": r.get("buffered"), "held": r.get("held")}
        rows.append([name, f"{r['final_acc']:.3f}", f"{r['best_acc']:.3f}",
                     int(late), int(drained), int(holds),
                     f"{r['total_bytes'] / 2**20:.2f}MiB"])

    for algo in algorithms:
        cell(algo, f"{algo}/no-deadline")
        for d in STRAGGLER_DEADLINES:
            for g in STRAGGLER_GAMMAS:
                cell(algo, f"{algo}/ddl{d:g}/g{g:g}",
                     f"comm.round_deadline_s={d}",
                     f"comm.staleness_gamma={g}")
    # graceful degradation: the PS holds w_t when a thin round cannot
    # reach quorum instead of averaging whatever trickled in
    tight = STRAGGLER_DEADLINES[-1]
    cell("mdsl", f"mdsl/ddl{tight:g}/g1/quorum4",
         f"comm.round_deadline_s={tight}", "comm.staleness_gamma=1.0",
         "comm.quorum=4")
    print_table(["cell", "final_acc", "best_acc", "late", "drained",
                 "holds", "total bytes"], rows,
                "straggler sweep — accuracy vs deadline x staleness-γ "
                "(Rayleigh 10 dB, 6 dB pathloss spread)")
    return out


def run(quick: bool = True, dataset: str = "mnist_like", seed: int = 0,
        algorithms: tuple[str, ...] = ("fedavg", "mdsl"),
        aggregator: str = "mean", downlink_compressor: str = "identity",
        adaptive_bits: bool = False, byzantine: int = 2,
        rounds_override: int | None = None, phy: bool = True,
        obs: bool = False, stragglers: bool = False, device=None) -> dict:
    device = resolve_device(device)
    if obs:
        _obs_enable(f"{dataset}__s{seed}")
    base = base_spec(quick=quick, dataset=dataset, seed=seed,
                     aggregator=aggregator,
                     downlink_compressor=downlink_compressor,
                     adaptive_bits=adaptive_bits)
    if rounds_override is not None:
        base = override(base, f"run.rounds={rounds_override}")
    rounds, workers = base.run.rounds, base.data.num_workers
    recs = {}
    for algo in algorithms:
        for cname, ovr in SWEEP:
            recs[(algo, cname)] = _run_one(base, f"algo.algorithm={algo}",
                                           *ovr, cell=f"{algo}+{cname}",
                                           device=device)

    # baselines: dense FedAvg when it ran, else the first algorithm's
    # identity run (run() accepts any algorithm subset)
    ref_algo = "fedavg" if "fedavg" in algorithms else algorithms[0]
    n = recs[(algorithms[0], "identity")]["n_params"]
    C = workers
    target = 0.9 * max(recs[(ref_algo, "identity")]["best_acc"], 1e-9)

    rows = []
    for (algo, cname), r in recs.items():
        rows.append([
            algo, cname, f"{r['final_acc']:.3f}",
            f"{sum(r['selected']) / rounds:.1f}/{C}",
            f"{r['compression_ratio']:.1f}x",
            f"{r['total_bytes_up'] / 2**20:.2f}MiB",
            f"{r['total_bytes_down'] / 2**20:.2f}MiB",
            rounds_to(r["acc"], target) or f">{rounds}",
            (lambda b: f"{b / 2**20:.2f}MiB" if b else "-")(
                bytes_to(r["acc"], r["bytes_total"], target))])
    print_table(
        ["algorithm", "compressor", "final_acc", "uploads/round",
         "ratio", "total up", "total down", f"rounds to {target:.2f}",
         f"bytes to {target:.2f}"],
        rows, "§IV-C — communication efficiency (non-iid I), "
              f"bytes on wire [agg={aggregator} "
              f"down={downlink_compressor}"
              f"{' adaptive' if adaptive_bits else ''}]")

    ref_total = recs[(ref_algo, "identity")]["total_bytes_up"]
    best_key = min(
        ((k, r) for k, r in recs.items()
         if r["final_acc"] >= target),
        key=lambda kr: kr[1]["total_bytes"], default=(None, None))[0]
    rec = {"n_params": n, "C": C, "rounds": rounds, "target_acc": target,
           "aggregator": aggregator,
           "downlink_compressor": downlink_compressor,
           "adaptive_bits": adaptive_bits,
           "ref_algorithm": ref_algo, "ref_dense_bytes": ref_total}
    if "fedavg" in algorithms and "mdsl" in algorithms:
        fed_total = recs[("fedavg", "identity")]["total_bytes_up"]
        mdsl_total = recs[("mdsl", "identity")]["total_bytes_up"]
        saving_sel = 1.0 - mdsl_total / fed_total
        print(f"M-DSL selection-only saving vs FedAvg: "
              f"{100 * saving_sel:.1f}%")
        rec.update({
            "fedavg_dense_bytes": fed_total,
            "mdsl_dense_bytes": mdsl_total,
            "selection_saving_frac": saving_sel,
            # legacy fields (parameter counts) kept for older consumers
            "fedavg_total_uploads": n * C * rounds,
            "mdsl_total_uploads": recs[("mdsl", "identity")][
                "total_uploaded_params"],
            "saving_frac": saving_sel,
            "mdsl_selected_trace": recs[("mdsl", "identity")]["selected"],
            "fedavg_acc": recs[("fedavg", "identity")]["acc"],
            "mdsl_acc": recs[("mdsl", "identity")]["acc"]})
    if best_key:
        best = recs[best_key]
        print(f"cheapest config reaching {target:.2f}: "
              f"{best_key[0]}+{best_key[1]} at "
              f"{best['total_bytes'] / 2**20:.2f}MiB up+down "
              f"({ref_total / max(best['total_bytes_up'], 1):.1f}x less "
              f"uplink than dense {ref_algo})")

    rec.update({"sweep": {f"{a}+{c}": {
               "final_acc": r["final_acc"],
               "acc": r["acc"],
               "total_bytes_up": r["total_bytes_up"],
               "total_bytes_down": r["total_bytes_down"],
               "total_bytes": r["total_bytes"],
               "bytes_up": r["bytes_up"],
               "bytes_down": r["bytes_down"],
               "compression_ratio": r["compression_ratio"],
               "selected": r["selected"],
               "delivered": r["delivered"],
           } for (a, c), r in recs.items()}})
    if phy:
        rec["phy_sweep"] = phy_sweep(base, device=device)
    if byzantine > 0:
        rec["byzantine_sweep"] = byzantine_sweep(base, byzantine,
                                                 device=device)
    if stragglers:
        srec = straggler_sweep(base, algorithms=algorithms, device=device)
        srec.update({"n_params": n, "C": C, "rounds": rounds})
        rec["straggler_sweep"] = srec
        print(f"straggler record -> {write_json('BENCH_stragglers', srec)}")
    save_record("comm_efficiency", rec)
    if _EM.active:
        _EM.run_end(rounds=0, totals={"cells": float(len(recs))})
        print(f"obs events -> {_EM.path}")
        _EM.close()
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale sweep (C=50, 20 rounds)")
    ap.add_argument("--quick", action="store_true",
                    help="explicit quick mode (default unless --full): "
                         "C=10 reduced-width fleet")
    ap.add_argument("--rounds", type=int, default=None,
                    help="override the round count (CI smoke runs)")
    ap.add_argument("--dataset", default="mnist_like")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--aggregator", default="mean",
                    choices=list(AGGREGATORS))
    ap.add_argument("--downlink-compressor", default="identity",
                    choices=list(COMPRESSORS))
    ap.add_argument("--adaptive-bits", action="store_true")
    ap.add_argument("--byzantine", type=int, default=2,
                    help="attackers in the robustness sweep (0 disables)")
    ap.add_argument("--no-phy", action="store_true",
                    help="skip the accuracy-vs-energy phy sweep "
                         "(5 extra runs over the Rayleigh regimes)")
    ap.add_argument("--obs", action="store_true",
                    help="stream per-cell SweepEvents (and per-round "
                         "run streams) under artifacts/obs/")
    ap.add_argument("--json", action="store_true",
                    help="run the straggler sweep (deadline x gamma) "
                         "and write artifacts/BENCH_stragglers__torch.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.full and args.quick:
        ap.error("--full and --quick are mutually exclusive")
    run(quick=not args.full, dataset=args.dataset, seed=args.seed,
        aggregator=args.aggregator,
        downlink_compressor=args.downlink_compressor,
        adaptive_bits=args.adaptive_bits, byzantine=args.byzantine,
        rounds_override=args.rounds, phy=not args.no_phy, obs=args.obs,
        stragglers=args.json, device=args.device)


if __name__ == "__main__":
    main()
