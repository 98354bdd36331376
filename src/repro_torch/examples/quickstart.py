"""Quickstart: the paper's pipeline through the port's experiment front
door (the counterpart of the root `examples/quickstart.py`).

Every run is a declarative `ExperimentSpec`: look a scenario up in the
registry, `override()` the axes you care about, `run()` it. The result
carries the full spec next to the metrics, so it can be re-run or swept
verbatim.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.experiments import get_scenario, override, run, to_dict


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # --- 1. a named scenario: 8-worker non-iid fleet, small paper CNN ---
    spec = get_scenario("quickstart")
    print("scenario:", spec.name, "->", to_dict(spec)["data"])

    # --- 2. tweak one axis the declarative way (sweeps are strings) -----
    spec = override(spec, "run.rounds=4", "comm.compressor=int8")

    # --- 3. run it: M-DSL rounds (Algorithm 1), selection + wire metrics -
    rec = run(spec, device=args.device).record
    print(f"\nmodel: {rec['model']}, {rec['n_params']:,} params, "
          f"{rec['num_workers']} workers")
    print("per-worker non-i.i.d. degree eta:",
          [f"{e:.2f}" for e in rec["eta"]])
    for t, (acc, sel) in enumerate(zip(rec["acc"], rec["selected"])):
        print(f"round {t + 1}: global acc {acc:.3f}  "
              f"selected {sel}/{rec['num_workers']}  "
              f"up {rec['bytes_up'][t] / 2**10:.0f} KiB")
    print(f"final acc {rec['final_acc']:.3f}, compression "
          f"{rec['compression_ratio']:.1f}x vs dense uplink")
    return rec


if __name__ == "__main__":
    main()
