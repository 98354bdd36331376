"""End-to-end edge-IoT comparison on the scenario registry: M-DSL vs
FedAvg on the paper's heterogeneous fleet (non-iid case II, Fig. 2 —
mixed Dirichlet alphas), the counterpart of the root
`examples/edge_iot_noniid.py`. One preset, one override per algorithm,
one `run()` each; prints convergence curves and the communication
saving, and checkpoints M-DSL's accuracy curve under
artifacts/examples/edge_iot__torch/.

    python -m repro_torch.examples.edge_iot_noniid [--rounds 8]
        [--workers 10] [--dataset mnist_like] [--device cpu]
"""
import argparse

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.experiments import get_scenario, override, run
from repro_torch.experiments.runner import ARTIFACTS


def ascii_curve(vals, width=40, lo=0.0, hi=1.0):
    out = []
    for v in vals:
        n = int((v - lo) / (hi - lo) * width)
        out.append("|" + "#" * n + " " * (width - n) + f"| {v:.3f}")
    return "\n".join(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--workers", type=int, default=10)
    ap.add_argument("--dataset", default="mnist_like")
    ap.add_argument("--width-mult", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    base = override(get_scenario("edge-iot/noniid2"),
                    f"run.rounds={args.rounds}",
                    f"data.num_workers={args.workers}",
                    f"data.dataset={args.dataset}",
                    f"model.width_mult={args.width_mult}")

    runs = {}
    for algo in ["fedavg", "mdsl"]:
        print(f"\n=== {algo} on non-iid case II "
              f"({args.workers} workers) ===")
        runs[algo] = run(override(base, f"algo.algorithm={algo}"),
                         device=args.device).record

    for algo, rec in runs.items():
        print(f"\n{algo} accuracy per round:")
        print(ascii_curve(rec["acc"]))

    fed, md = runs["fedavg"], runs["mdsl"]
    n, C, R = md["n_params"], args.workers, args.rounds
    saving = 1 - md["total_uploaded_params"] / (n * C * R)
    print(f"\nfinal acc: fedavg {fed['final_acc']:.3f}  "
          f"mdsl {md['final_acc']:.3f}")
    print(f"M-DSL upload saving vs FedAvg: {100 * saving:.1f}% "
          f"(mean {sum(md['selected']) / R:.1f}/{C} workers/round)")

    # checkpoint the better model's metrics record
    ckpt_dir = ARTIFACTS / "examples" / "edge_iot__torch"
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
    mgr.save(args.rounds, {"acc": torch.tensor(md["acc"])},
             metadata={"algorithm": "mdsl", "final_acc": md["final_acc"]})
    print(f"checkpointed to {ckpt_dir}")
    return runs


if __name__ == "__main__":
    main()
