"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each number compared with its limit (also the last lines
of standard error). Exits non-zero with no result when the card is
missing, when the cell asks for more cards than there are, or when JAX
or the JAX package was loaded."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]


def main(argv=None) -> int:
    from bench import harness
    t_start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    bm = harness.benchmark()
    chips = harness.entry(bm, args.workload)["chips"]
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", bm=bm, t_start=t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"[bench] loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"[check] {k} {c['value']!r} <= {c['limit']!r} {ok} "
              f"(worst: {c['at']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
