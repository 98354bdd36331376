"""Training driver of the port — a thin CLI over `repro_torch.experiments`:

  python -m repro_torch.launch.train --scenario low-bandwidth-int4 \\
      --rounds 3 [--out PATH] [--device cpu]
  python -m repro_torch.launch.train --scenario mesh/smollm-smoke \\
      --set model.reduced=false --set model.seq_len=2048 --rounds 3 \\
      [--ckpt-dir DIR]
  python -m repro_torch.launch.train --scenario low-bandwidth-int4 \\
      --obs [--obs-dir DIR] [--profile-dir DIR]
  python -m repro_torch.launch.train --list-scenarios

`--set KEY=VALUE` (repeatable) overrides any dotted spec path, after
`--rounds`, `--out` and the obs and checkpoint flags, as the reference's
CLI does. `--obs`, `--obs-dir` and `--profile-dir` each turn the event
stream on (`run.obs.*`); the run then prints the stream's path and the
monitor command that renders it. `--ckpt-dir` keeps the mesh engine's
global params after every round (`run.ckpt_dir`).

Runs on the CUDA card unless `--device` names another; with no card and
no `--device` it fails instead of falling back to the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.experiments import (default_out, describe_scenarios,
                                     get_scenario, override, run)


def _flag_overrides(args: argparse.Namespace) -> list[str]:
    """--rounds/--out/--obs/--obs-dir/--profile-dir/--ckpt-dir -> spec
    overrides (any of the three obs flags switches the stream on)."""
    ovr = []
    if args.rounds is not None:
        ovr.append(f"run.rounds={args.rounds}")
    if args.out is not None:
        ovr.append(f"run.out={args.out}")
    if args.obs or args.obs_dir or args.profile_dir:
        ovr.append("run.obs.enabled=true")
    if args.obs_dir:
        ovr.append(f"run.obs.dir={args.obs_dir}")
    if args.profile_dir:
        ovr.append(f"run.obs.profile_dir={args.profile_dir}")
    if args.ckpt_dir:
        ovr.append(f"run.ckpt_dir={args.ckpt_dir}")
    return ovr


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Run one registered scenario on the port.")
    ap.add_argument("--scenario", default=None,
                    help="preset from repro_torch.experiments.registry")
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--out", default=None, help="metrics JSON path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a dotted spec path (repeatable), e.g. "
                         "--set model.reduced=false")
    ap.add_argument("--ckpt-dir", default=None,
                    help="mesh checkpoint directory (ckpt_<step>.npz)")
    ap.add_argument("--obs", action="store_true",
                    help="stream typed telemetry events to a JSONL file "
                         "under artifacts/obs/ (tail it with python -m "
                         "repro_torch.launch.monitor --follow)")
    ap.add_argument("--obs-dir", default=None,
                    help="event stream directory (implies --obs)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of a window "
                         "of rounds into this dir (implies --obs)")
    args = ap.parse_args(argv)
    if args.list_scenarios:
        width = max(len(n) for n, _ in describe_scenarios())
        for name, what in describe_scenarios():
            print(f"{name.ljust(width)}  {what}")
        return
    if args.scenario is None:
        ap.error("--scenario is required (or --list-scenarios)")
    try:
        spec = get_scenario(args.scenario)
        assignments = _flag_overrides(args) + args.set
        if assignments:
            spec = override(spec, *assignments)
        spec = spec.validate()
    except ValueError as e:
        ap.error(str(e))
    result = run(spec, device=args.device)
    out = result.save(default_out(spec))
    print(f"wrote {out}")
    if result.events_path:
        print(f"events {result.events_path}\n"
              f"  view: python -m repro_torch.launch.monitor "
              f"{result.events_path}")


if __name__ == "__main__":
    main()
