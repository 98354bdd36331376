"""Training driver of the port — a thin CLI over `repro_torch.experiments`:

  python -m repro_torch.launch.train --scenario low-bandwidth-int4 \\
      --rounds 3 [--out PATH] [--device cpu]
  python -m repro_torch.launch.train --scenario mesh/smollm-smoke \\
      --set model.reduced=false --set model.seq_len=2048 --rounds 3

`--set KEY=VALUE` (repeatable) overrides any dotted spec path, after
`--rounds` and `--out`, as the reference's CLI does.

Runs on the CUDA card unless `--device` names another; with no card and
no `--device` it fails instead of falling back to the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.experiments import default_out, get_scenario, override, run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Run one registered scenario on the port.")
    ap.add_argument("--scenario", required=True,
                    help="preset from repro_torch.experiments.registry")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--out", default=None, help="metrics JSON path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a dotted spec path (repeatable), e.g. "
                         "--set model.reduced=false")
    args = ap.parse_args(argv)
    try:
        spec = get_scenario(args.scenario)
        if args.rounds is not None:
            spec = override(spec, f"run.rounds={args.rounds}")
        if args.out is not None:
            spec = override(spec, f"run.out={args.out}")
        if args.set:
            spec = override(spec, *args.set)
        spec = spec.validate()
    except ValueError as e:
        ap.error(str(e))
    result = run(spec, device=args.device)
    out = result.save(default_out(spec))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
