"""Paper Fig. 3 on the port: classification accuracy of FedAvg / DSL /
Multi-DSL / M-DSL under iid, non-iid-I (Dir 0.5) and non-iid-II (mixed
fleet), the counterpart of the JAX package's `benchmarks/fig3_accuracy.py`.

Each case is the `paper/fig3-<case>` preset; the algorithm axis and the
quick-mode shrink are dotted-path overrides. The 12 cells run through
`experiments.sweep`, so `--jobs N` spreads them over N spawned processes
(each cell's record is the one it gives serially, bit for bit).

Claims validated:
  * iid is the ceiling all methods approach;
  * under non-iid data M-DSL converges faster and reaches higher accuracy
    than FedAvg and single-best-worker DSL;
  * Multi-DSL (selection without eta) sits between DSL and M-DSL,
    isolating the contribution of the non-i.i.d. degree metric.

    python -m repro_torch.figures.fig3_accuracy [--quick | --full] [--jobs 2]
        [--dataset mnist_like] [--seed 0] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.experiments import get_scenario, override, sweep
from repro_torch.figures.common import BENCH_OUT, print_table, save_record

ALGOS = ["fedavg", "dsl", "multi_dsl", "mdsl"]
CASES = ["iid", "noniid1", "noniid2"]

QUICK = ("run.rounds=8", "model.width_mult=2", "algo.local_epochs=1",
         "data.num_workers=10", "data.n_local=256",
         "algo.hp.learning_rate=0.05")


def case_spec(case: str, quick: bool, dataset: str, seed: int):
    spec = get_scenario(f"paper/fig3-{case}")
    if quick:
        spec = override(spec, *QUICK)
    return override(spec, f"data.dataset={dataset}", f"run.seed={seed}")


def run(quick: bool = True, dataset: str = "mnist_like", seed: int = 0,
        jobs: int = 1, device=None) -> dict:
    rounds = 8 if quick else 20
    grid = [(case, algo) for case in CASES for algo in ALGOS]
    specs = [override(case_spec(case, quick, dataset, seed),
                      f"algo.algorithm={algo}") for case, algo in grid]
    cells = sweep(specs, seeds=(seed,), jobs=jobs, device=device,
                  out_dir=BENCH_OUT / "fig3_accuracy__torch")
    results: dict = {}
    for (case, algo), res in zip(grid, cells):
        rec = res.record
        results[f"{algo}/{case}"] = {
            "acc_curve": rec["acc"], "final_acc": rec["final_acc"],
            "best_acc": rec["best_acc"],
            "mean_selected": sum(rec["selected"]) / len(rec["selected"]),
        }
        print(f"  {algo:>9s} / {case:<7s} final_acc="
              f"{rec['final_acc']:.3f} best={rec['best_acc']:.3f}",
              flush=True)

    rows = []
    for case in CASES:
        row = [case] + [f"{results[f'{a}/{case}']['final_acc']:.3f}"
                        for a in ALGOS]
        rows.append(row)
    print_table(["case"] + ALGOS, rows,
                f"Fig. 3 — final accuracy ({dataset}, {rounds} rounds)")

    # headline claims as machine-checkable booleans
    claims = {}
    for case in ["noniid1", "noniid2"]:
        m = results[f"mdsl/{case}"]["final_acc"]
        claims[f"mdsl_beats_fedavg_{case}"] = (
            m >= results[f"fedavg/{case}"]["final_acc"] - 0.02)
        claims[f"mdsl_beats_dsl_{case}"] = (
            m >= results[f"dsl/{case}"]["final_acc"] - 0.02)
    print("claims:", claims)
    rec = {"results": results, "claims": claims, "rounds": rounds,
           "dataset": dataset, "quick": quick}
    save_record("fig3_accuracy", rec)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="paper scale (C=50, CNN5 w8, 20 rounds)")
    ap.add_argument("--quick", action="store_true",
                    help="C=10, CNN5 w2, 8 rounds (the default)")
    ap.add_argument("--dataset", default="mnist_like")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jobs", type=int, default=1,
                    help="spawned processes for the 12 cells")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.full and args.quick:
        ap.error("--full and --quick are mutually exclusive")
    run(quick=not args.full, dataset=args.dataset, seed=args.seed,
        jobs=args.jobs, device=args.device)


if __name__ == "__main__":
    main()
