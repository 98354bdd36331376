"""Population-engine scaling on the port: round cost vs registered
fleet size, the counterpart of the JAX package's
`benchmarks/population_bench.py`.

The sampled-cohort engine (core/population.py) holds O(P) persistent
scalars but does O(K) work per round, so the per-round wall time over
P in {1k, 100k, 1M} at fixed K should be flat: the training round
dominates, and the schedule (Gumbel-top-k over P) and the scatter
(K-row writes into the (P,) columns) stay in the noise. This driver
records that curve:

  * per-round wall time of the full wrapped step (schedule + reseat +
    inner round + scatter), averaged over the rounds after the first;
  * the isolated schedule and scatter cost at each P;
  * the registry footprint (36 B/device).

Times end in a device sync. `--json` writes
artifacts/BENCH_population__torch.json (the reference's
BENCH_population.json schema); `--quick` times fewer rounds.

    python -m repro_torch.figures.population_bench [--quick] [--json]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import population as pop
from repro_torch.experiments.registry import get_scenario
from repro_torch.experiments.runner import build
from repro_torch.experiments.spec import override
from repro_torch.figures.common import (print_table, save_record, sync,
                                        write_json)
from repro_torch.kernels.runtime import resolve_device

POPULATIONS = (1_000, 100_000, 1_000_000)


def _time(fn, reps: int, device: torch.device) -> float:
    fn()                               # warm-up
    sync(device)
    t0 = time.time()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.time() - t0) / reps


def bench_population(P: int, rounds: int, reps: int, device) -> dict:
    spec = override(get_scenario("fleet/million-uniform"),
                    f"fleet.population={P}", f"run.rounds={rounds}")
    t0 = time.time()
    prep = build(spec, device)
    sync(prep.device)
    build_s = time.time() - t0
    K, comm, dev = spec.data.num_workers, spec.comm, prep.device

    # the isolated O(P)-facing pieces: the draws, sampler and gather (the
    # reference draws inside its schedule), and the K-row scatter
    # against a P-wide table
    table = prep.state.table
    gen = torch.Generator(device=dev).manual_seed(0)

    def sched():
        draws = pop.population_draws(gen, comm, P, K, "uniform", dev)
        return pop.schedule(table, 1, draws, comm=comm, cohort_size=K,
                            policy="uniform")

    schedule_s = _time(sched, reps, dev)
    idx, phy = sched()
    theta = torch.zeros((K,), dtype=torch.float32, device=dev)
    scatter_s = _time(
        lambda: pop.scatter_round(table, idx, phy, theta, theta, 1), reps,
        dev)

    # full wrapped rounds: the first is the warm-up, the rest are timed
    state = prep.state
    round_times = []
    for _ in range(rounds):
        t1 = time.time()
        state, metrics = prep.step(state, prep.draw(state))
        sync(dev)
        round_times.append(time.time() - t1)
    timed = round_times[1:] or round_times
    return {"population": P, "cohort": K,
            "round_s": round(sum(timed) / len(timed), 4),
            "round0_s": round(round_times[0], 4),
            "schedule_s": round(schedule_s, 6),
            "scatter_s": round(scatter_s, 6),
            "table_mb": round(pop.table_bytes(table) / 1e6, 2),
            "build_s": round(build_s, 2),
            "final_loss": float(metrics.global_loss)}


def run(quick: bool = False, write: bool = False, device=None) -> dict:
    device = resolve_device(device)
    rounds = 2 if quick else 4
    reps = 3 if quick else 10
    rows = [bench_population(P, rounds, reps, device) for P in POPULATIONS]
    print_table(
        ["P", "K", "round_s", "schedule_s", "scatter_s", "table_mb"],
        [[r["population"], r["cohort"], r["round_s"], r["schedule_s"],
          r["scatter_s"], r["table_mb"]] for r in rows],
        "Population engine — per-round cost vs registered fleet size")
    rec = {"schema": 1, "fixed_cohort": rows[0]["cohort"],
           "quick": quick, "rows": rows}
    save_record("population_bench", rec)
    if write:
        print(f"wrote {write_json('BENCH_population', rec)}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="fewer timed rounds and repeats")
    ap.add_argument("--json", action="store_true",
                    help="write artifacts/BENCH_population__torch.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(quick=args.quick, write=args.json, device=args.device)


if __name__ == "__main__":
    main()
