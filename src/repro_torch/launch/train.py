"""Training driver of the port — a thin CLI over `repro_torch.experiments`,
flag for flag the JAX package's `launch/train.py`:

  python -m repro_torch.launch.train --list-scenarios
  python -m repro_torch.launch.train --scenario low-bandwidth-int4 \\
      --rounds 3 [--out PATH] [--device cpu]
  python -m repro_torch.launch.train --scenario mesh/smollm-smoke \\
      --set model.reduced=false --set model.seq_len=2048 --steps 3 \\
      [--ckpt-dir DIR]
  python -m repro_torch.launch.train --scenario low-bandwidth-int4 \\
      --obs [--obs-dir DIR] [--profile-dir DIR]
  python -m repro_torch.launch.train --mode paper --algorithm mdsl \\
      --case noniid2 --rounds 40 --compressor int4 --adaptive-bits
  python -m repro_torch.launch.train --mode mesh --arch smollm-360m \\
      --steps 5
  python -m repro_torch.launch.train --sweep \\
      paper/fig3-iid,paper/fig3-noniid1,paper/fig3-noniid2 \\
      --sweep-axis algo.algorithm=fedavg,dsl,multi_dsl,mdsl \\
      --seeds 0,1 --jobs 2

Precedence: scenario preset (or the `--mode` default) < the per-axis
flags < `--set KEY=VALUE` overrides. The spec is validated at parse
time, so a bad flag fails before any round: a paper flag on a mesh spec
(or the reverse), and with `--sweep` any per-axis flag, is an error, as
in the reference. `--obs`, `--obs-dir` and `--profile-dir` each turn the
event stream on (`run.obs.*`); the run then prints the stream's path and
the monitor command that renders it. `--ckpt-dir` keeps the mesh
engine's global params after every round (`run.ckpt_dir`). `--jobs N`
runs a sweep's cells in N spawned processes.

Runs on the CUDA card unless `--device` names another; with no card and
no `--device` it fails instead of falling back to the CPU. Unlike the
reference, a bare invocation does not run the default paper spec: it
asks for `--scenario`, `--mode` or `--sweep`.

`run_paper_experiment` / `run_mesh_training` are the reference's
deprecated keyword shims over `experiments.run`.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.comm import (AGGREGATORS, BYZANTINE_MODES, CHANNELS,
                              COMPRESSORS, FADING_MODELS, TIER_RANKS,
                              CommConfig)
from repro_torch.experiments import (ExperimentSpec, default_out,
                                     describe_scenarios, get_scenario,
                                     override, run, sweep)
from repro_torch.experiments.runner import (ARTIFACTS, CASES, IMAGE_SPECS,
                                            _noniid2_groups, make_case_data,
                                            spec_from_mesh_kwargs,
                                            spec_from_paper_kwargs)
from repro_torch.experiments.spec import PAPER_DATASETS, PARTITION_CASES

# legacy alias (the reference's callers imported the spec table here)
SPECS = IMAGE_SPECS

__all__ = ["ARTIFACTS", "CASES", "SPECS", "run_paper_experiment",
           "run_mesh_training", "make_case_data", "build_spec_from_args",
           "build_sweep_specs", "main", "_noniid2_groups"]


def run_paper_experiment(algorithm: str = "mdsl", case: str = "noniid1",
                         dataset: str = "mnist_like", rounds: int = 20,
                         num_workers: int = 50, model: str = "cnn",
                         width_mult: int = 8, tau: float = 0.9,
                         local_epochs: int = 4, batch_size: int = 64,
                         lr: float = 0.01, velocity_clip: float = 0.1,
                         seed: int = 0, eta_coeffs: Optional[tuple] = None,
                         n_local: int = 512, log_every: int = 1,
                         comm: Optional[CommConfig] = None,
                         verbose: bool = True, device=None) -> dict:
    """Deprecated: build an `ExperimentSpec` and call
    `repro_torch.experiments.run` instead. Returns the metrics record."""
    spec = spec_from_paper_kwargs(
        algorithm=algorithm, case=case, dataset=dataset, rounds=rounds,
        num_workers=num_workers, model=model, width_mult=width_mult,
        tau=tau, local_epochs=local_epochs, batch_size=batch_size, lr=lr,
        velocity_clip=velocity_clip, seed=seed, eta_coeffs=eta_coeffs,
        n_local=n_local, log_every=log_every, comm=comm)
    return run(spec, verbose=verbose, device=device).record


def run_mesh_training(arch: str, steps: int = 5, reduced: bool = True,
                      seq_len: int = 128, per_worker_batch: int = 2,
                      num_spatial: int = 2, ckpt_dir: Optional[str] = None,
                      seed: int = 0, comm: Optional[CommConfig] = None,
                      verbose: bool = True, device=None) -> dict:
    """Deprecated: build an `ExperimentSpec` and call
    `repro_torch.experiments.run` instead. Returns the metrics record."""
    spec = spec_from_mesh_kwargs(
        arch=arch, steps=steps, reduced=reduced, seq_len=seq_len,
        per_worker_batch=per_worker_batch, num_spatial=num_spatial,
        ckpt_dir=ckpt_dir, seed=seed, comm=comm)
    return run(spec, verbose=verbose, device=device).record


# (flag attribute, dotted spec path): None-defaulted flags are applied
# only when the user passed them, so scenario presets keep their values
_COMMON_FLAGS = [
    ("algorithm", "algo.algorithm"), ("workers", "data.num_workers"),
    ("seed", "run.seed"), ("tau", "algo.tau"), ("out", "run.out"),
    ("compressor", "comm.compressor"), ("topk_ratio", "comm.topk_ratio"),
    ("channel", "comm.channel"), ("drop_prob", "comm.drop_prob"),
    ("snr_db", "comm.snr_db"), ("byzantine", "comm.byzantine"),
    ("byzantine_mode", "comm.byzantine_mode"),
    ("byzantine_scale", "comm.byzantine_scale"),
    ("aggregator", "comm.aggregator"), ("trim_ratio", "comm.trim_ratio"),
    ("downlink_compressor", "comm.downlink_compressor"),
    ("fading", "comm.fading"), ("doppler_rho", "comm.doppler_rho"),
    ("pathloss_spread_db", "comm.pathloss_spread_db"),
    ("outage_snr_db", "comm.outage_snr_db"),
    ("num_tiers", "comm.num_tiers"), ("tier_rank", "comm.tier_rank"),
    ("round_deadline_s", "comm.round_deadline_s"),
    ("staleness_gamma", "comm.staleness_gamma"), ("quorum", "comm.quorum"),
    ("fault_prob", "comm.fault_prob"), ("fault_rounds", "comm.fault_rounds"),
    ("fault_seed", "comm.fault_seed"),
]
_PAPER_FLAGS = [
    ("case", "data.case"), ("dataset", "data.dataset"),
    ("rounds", "run.rounds"), ("model", "model.name"),
    ("width_mult", "model.width_mult"),
]
_MESH_FLAGS = [
    ("arch", "model.name"), ("steps", "run.rounds"),
    ("ckpt_dir", "run.ckpt_dir"),
]


def _obs_overrides(args: argparse.Namespace) -> list[str]:
    """--obs / --obs-dir / --profile-dir -> run.obs.* overrides (any of
    them switches the event stream on). getattr-safe, so a Namespace
    built by hand without the flags works."""
    ovr = []
    obs_dir = getattr(args, "obs_dir", None)
    profile_dir = getattr(args, "profile_dir", None)
    if getattr(args, "obs", False) or obs_dir or profile_dir:
        ovr.append("run.obs.enabled=true")
    if obs_dir:
        ovr.append(f"run.obs.dir={obs_dir}")
    if profile_dir:
        ovr.append(f"run.obs.profile_dir={profile_dir}")
    return ovr


def build_spec_from_args(args: argparse.Namespace) -> ExperimentSpec:
    """scenario preset (or the mode's default) -> per-axis flags -> --set
    overrides (`args.set`, as this module's parser stores them)."""
    if args.scenario:
        spec = get_scenario(args.scenario)
    elif args.mode == "mesh":
        spec = spec_from_mesh_kwargs(arch=args.arch or "smollm-360m")
    else:
        spec = ExperimentSpec()
    paper = spec.model.kind == "paper"
    # fail fast on explicitly passed flags the spec kind cannot honor
    # (silently dropping --rounds on a mesh scenario fakes a longer run)
    wrong_kind = [attr for attr, _ in (_MESH_FLAGS if paper
                                       else _PAPER_FLAGS)
                  if getattr(args, attr) is not None]
    if wrong_kind:
        names = ", ".join("--" + a.replace("_", "-") for a in wrong_kind)
        raise ValueError(
            f"{names} does not apply to a {spec.model.kind!r} spec "
            f"({'use --steps/--arch' if not paper else 'use --rounds'} "
            f"or a --set override instead)")
    for attr, path in _COMMON_FLAGS + (_PAPER_FLAGS if paper
                                       else _MESH_FLAGS):
        v = getattr(args, attr)
        if v is not None:
            spec = override(spec, f"{path}={v}")
    if args.no_error_feedback:
        spec = override(spec, "comm.error_feedback=false")
    if args.adaptive_bits:
        spec = override(spec, "comm.adaptive_bits=true")
    for assignment in _obs_overrides(args) + list(args.set):
        spec = override(spec, assignment)
    return spec.validate()


def build_sweep_specs(args: argparse.Namespace) -> list[ExperimentSpec]:
    """--sweep grid: scenario presets x --sweep-axis value lists, with
    every --set override applied to each cell. The paper's Fig.-3 grid is
    one command:

        python -m repro_torch.launch.train --sweep \\
            paper/fig3-iid,paper/fig3-noniid1,paper/fig3-noniid2 \\
            --sweep-axis algo.algorithm=fedavg,dsl,multi_dsl,mdsl \\
            --seeds 0,1,2,3,4 --jobs 2
    """
    names = [n.strip() for n in args.sweep.split(",") if n.strip()]
    if not names:
        raise ValueError("--sweep needs at least one scenario name")
    specs = [get_scenario(n) for n in names]
    for assignment in args.set:
        specs = [override(s, assignment) for s in specs]
    for axis in args.sweep_axis:
        path, eq, raw = axis.partition("=")
        values = [v.strip() for v in raw.split(",") if v.strip()]
        if not eq or not values:
            raise ValueError(f"--sweep-axis must look like "
                             f"key=v1,v2,..., got {axis!r}")
        specs = [override(s, f"{path}={v}") for s in specs for v in values]
    for assignment in _obs_overrides(args):
        specs = [override(s, assignment) for s in specs]
    return [s.validate() for s in specs]


def parser() -> argparse.ArgumentParser:
    """The CLI's parser (`build_spec_from_args` reads its Namespace)."""
    ap = argparse.ArgumentParser(
        description="Run one experiment on the port: --scenario NAME "
                    "[--set k=v ...], the per-axis flags, or a --sweep.")
    ap.add_argument("--scenario", default=None,
                    help="preset from repro_torch.experiments.registry")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a dotted spec path (repeatable), e.g. "
                         "--set model.reduced=false")
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mode", default=None, choices=["paper", "mesh"],
                    help="default spec kind when no --scenario is given")
    # paper mode
    ap.add_argument("--algorithm", default=None,
                    choices=["fedavg", "dsl", "multi_dsl", "mdsl"])
    ap.add_argument("--case", default=None, choices=list(PARTITION_CASES))
    ap.add_argument("--dataset", default=None, choices=list(PAPER_DATASETS))
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--model", default=None, choices=["cnn", "resnet"])
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--tau", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default=None, help="metrics JSON path")
    # comm (both modes)
    ap.add_argument("--compressor", default=None, choices=list(COMPRESSORS))
    ap.add_argument("--topk-ratio", type=float, default=None)
    ap.add_argument("--no-error-feedback", action="store_true")
    ap.add_argument("--channel", default=None, choices=list(CHANNELS))
    ap.add_argument("--drop-prob", type=float, default=None)
    ap.add_argument("--snr-db", type=float, default=None)
    ap.add_argument("--byzantine", type=int, default=None)
    ap.add_argument("--byzantine-mode", default=None,
                    choices=list(BYZANTINE_MODES))
    ap.add_argument("--byzantine-scale", type=float, default=None)
    ap.add_argument("--aggregator", default=None, choices=list(AGGREGATORS))
    ap.add_argument("--trim-ratio", type=float, default=None)
    ap.add_argument("--downlink-compressor", default=None,
                    choices=list(COMPRESSORS))
    ap.add_argument("--adaptive-bits", action="store_true")
    # physical layer (comm.phy)
    ap.add_argument("--fading", default=None, choices=list(FADING_MODELS))
    ap.add_argument("--doppler-rho", type=float, default=None)
    ap.add_argument("--pathloss-spread-db", type=float, default=None)
    ap.add_argument("--outage-snr-db", type=float, default=None)
    ap.add_argument("--num-tiers", type=int, default=None)
    ap.add_argument("--tier-rank", default=None, choices=list(TIER_RANKS))
    # straggler / deadline engine + fault injection (comm.straggler)
    ap.add_argument("--round-deadline-s", type=float, default=None)
    ap.add_argument("--staleness-gamma", type=float, default=None)
    ap.add_argument("--quorum", type=int, default=None)
    ap.add_argument("--fault-prob", type=float, default=None)
    ap.add_argument("--fault-rounds", type=int, default=None)
    ap.add_argument("--fault-seed", type=int, default=None)
    # mesh mode
    ap.add_argument("--arch", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="mesh checkpoint directory (ckpt_<step>.npz)")
    # observability (repro_torch.obs; any of these enables the stream)
    ap.add_argument("--obs", action="store_true",
                    help="stream typed telemetry events to a JSONL file "
                         "under artifacts/obs/ (tail it with python -m "
                         "repro_torch.launch.monitor --follow)")
    ap.add_argument("--obs-dir", default=None,
                    help="event stream directory (implies --obs)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of a window "
                         "of rounds into this dir (implies --obs)")
    # sweep mode: --sweep S1,S2 [--sweep-axis k=v1,v2]... [--seeds ..]
    ap.add_argument("--sweep", default=None, metavar="SCENARIOS",
                    help="comma-separated scenario names to sweep (each "
                         "crossed with --sweep-axis values, --seeds, and "
                         "any --set overrides)")
    ap.add_argument("--sweep-axis", action="append", default=[],
                    metavar="KEY=V1,V2,...",
                    help="cross-product axis over a dotted spec path, e.g. "
                         "algo.algorithm=fedavg,dsl,multi_dsl,mdsl "
                         "(repeatable)")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seeds for --sweep (default 0)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="spawned processes for --sweep (1 = serial)")
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)

    if args.list_scenarios:
        width = max(len(n) for n, _ in describe_scenarios())
        for name, what in describe_scenarios():
            print(f"{name.ljust(width)}  {what}")
        return

    if args.sweep:
        # a per-axis flag that --sweep would silently drop fakes results
        # for a config the user never ran: demand the --set / --sweep-axis
        # spelling
        stray = [attr for attr, _ in
                 _COMMON_FLAGS + _PAPER_FLAGS + _MESH_FLAGS
                 if getattr(args, attr) is not None]
        stray += [f for f in ("no_error_feedback", "adaptive_bits")
                  if getattr(args, f)]
        if stray:
            names = ", ".join("--" + a.replace("_", "-") for a in stray)
            ap.error(f"{names} does not combine with --sweep — spell "
                     f"shared values as --set key=value and swept values "
                     f"as --sweep-axis key=v1,v2")
        try:
            specs = build_sweep_specs(args)
            seeds = ([int(s) for s in args.seeds.split(",") if s.strip()]
                     if args.seeds else [0])
        except ValueError as e:
            ap.error(str(e))
        results = sweep(specs, seeds=seeds, jobs=args.jobs,
                        device=args.device)
        print(f"swept {len(results)} runs "
              f"({len(specs)} specs x {len(seeds)} seeds, "
              f"jobs={args.jobs})")
        return

    if args.scenario is None and args.mode is None:
        ap.error("--scenario, --mode or --sweep is required "
                 "(or --list-scenarios)")
    try:
        spec = build_spec_from_args(args)
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
