"""The readings that the limits of `correct` are set from, on the card at
a cell's own size (not run by the benchmark's runs):

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--faults]

For each seed of --seeds, the program's first rounds against the plain
reference (the sound runs: the lower readings). For each control seed,
the reference in the next precision below the configuration's (the
workload's `check.control`: TF32 for f32, fp8 for bf16) put in the
program's place, against the reference (the control: the upper
readings), and with --faults the reference with one fault planted, put
in the program's place likewise: half of each batch left out, every
worker selected. One JSON line a reading on standard output."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

FAULTS = ("half_batch", "select_all")


def _line(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main(argv=None) -> int:
    import torch
    from bench import harness
    from bench.reference import compare
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    cell = harness.load_json("workloads", args.workload)
    cfg = harness.load_json("configs", cell["config"])
    tau = cell["algorithm"]["tau"]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    import importlib
    Engine = importlib.import_module(f"bench.engines.{cell['engine']}").Engine
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in dict.fromkeys(seeds + controls):
        t0 = time.time()
        e = Engine(cell, cfg, seed, "cuda")
        e.setup()
        t1 = time.time()
        e.free()
        gc.collect()
        torch.cuda.empty_cache()
        if seed in seeds:
            got = compare.compare(e.program_readings(), e.reference(),
                                  e.paths, tau)
            _line(workload=args.workload, seed=seed, side="program",
                  setup_s=t1 - t0, ref_s=time.time() - t1,
                  **{k: v[0] for k, v in got.items()},
                  at={k: v[1] for k, v in got.items()})
        if seed not in controls:
            continue
        own = [{}] * len(e.records)
        kinds = [("control", dict(precision=cell["check"]["control"]))]
        if args.faults:
            kinds += [(f, dict(fault=f)) for f in FAULTS]
        for side, kw in kinds:
            t2 = time.time()
            low = e.reference(hints=own, **kw)
            ref = e.reference(hints=low.taken())
            got = compare.compare(low, ref, e.paths, tau)
            _line(workload=args.workload, seed=seed, side=side,
                  ref_s=time.time() - t2, **{k: v[0] for k, v in got.items()},
                  at={k: v[1] for k, v in got.items()})
        del e
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
