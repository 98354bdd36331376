"""Attribution profiler over the dry-run's op tables (the JAX package's
`launch/profile.py`).

Prints the top contributors (issuing port function x op) to the memory
(HBM bytes), FLOP and collective roofline terms: given a dominant term,
this shows which function and op class to attack. The reference weights
each HLO computation by its while-loop trip count; the port's table
already sums every dispatched call (`launch/op_costmodel.py`).

Usage:
  python -m repro_torch.launch.profile artifacts/dryrun_torch/smollm-360m__train_4k__single.ops.json.gz
  python -m repro_torch.launch.profile <table.ops.json.gz> --term flops --top 20
"""
from __future__ import annotations

import argparse
import gzip
import json
from pathlib import Path

_FIELD = {"memory": "bytes", "flops": "flops", "collective": "coll_bytes"}


def attribute(op_table: list[dict], term: str = "memory"
              ) -> list[tuple[float, str, str]]:
    """-> [(bytes_or_flops, port function, op)], sorted descending; the
    rows that add nothing to the term are left out."""
    field = _FIELD[term]
    return sorted(((float(r[field]), r["fn"], r["op"]) for r in op_table
                   if r[field]), reverse=True)


def load(path) -> list[dict]:
    p = Path(path)
    with (gzip.open(p, "rt") if p.suffix == ".gz" else open(p)) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("table", help="a dry-run's .ops.json.gz (or .json)")
    ap.add_argument("--term", default="memory",
                    choices=["memory", "flops", "collective"])
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    rows = attribute(load(args.table), args.term)
    total = sum(v for v, _, _ in rows)
    unit = "flops" if args.term == "flops" else "bytes"
    print(f"{args.term} total: {total:.3e} {unit} "
          f"({Path(args.table).name}, every dispatched call)")
    for v, name, op in rows[: args.top]:
        print(f"  {v / total * 100:5.1f}%  {v:.3e}  {op:34s} {name[:52]}")


if __name__ == "__main__":
    main()
