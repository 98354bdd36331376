#!/usr/bin/env python3
"""Card check of the paper engine's run-to-run determinism, for work on
the runner's numerics (`experiments/runner._deterministic_f32`).

    python3 determinism_probe.py            # one CUDA card and nvcc; ~1 min
    python3 determinism_probe.py --strict   # under PyTorch's strict mode

1. The op: the vmapped gradients of CNN5 width 8 (C = 50 workers, one
   minibatch of 64 each, as LocalUpdate computes them) five times on
   the same inputs, with cuDNN free to pick its algorithms (the runner's
   former numerics: TF32 off only) and then held to deterministic ones;
   prints, for each leaf, whether a repeat differed from the first and
   by how much. A conv weight whose own gradient differs while the
   dense layers above it agree points at cuDNN's weight-gradient
   algorithm.
2. The cost: `low-bandwidth-int4` at full width (3 rounds) under the
   former numerics and the runner's own, in turns (former, now, now,
   former, twice); prints each run's seconds a round, the medians of
   the steady rounds (rounds 2-3) of each side, and whether the runs
   of each side gave equal records.
3. The same four-run check of the int4 `straggler/deadline-tight` run.

With `--strict` it runs instead both scenarios twice under the former
numerics with `torch.use_deterministic_algorithms(True)` (and
`CUBLAS_WORKSPACE_CONFIG=:4096:8`, set before CUDA starts): an op with
no deterministic implementation raises, the rest are pinned, so equal
records there say no such op is on the path. Prints any warning an op
gives.

Every line carries the card's name and power limit. Exits non-zero if
runs that should agree (the runner's own; with `--strict`, the strict
ones) disagree; an op with no deterministic implementation raises.
"""
import contextlib
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUND_KEYS = ("acc", "global_loss", "selected", "delivered", "late",
              "drained", "buffered", "held")


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else f"nvidia-smi failed: {smi.stderr.strip()}")


@contextlib.contextmanager
def former_numerics():
    """The runner's numerics before the fix: TF32 off, cuDNN unpinned."""
    import torch
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


def grad_check(card: str) -> None:
    import torch
    from repro_torch.configs.paper_cnn import paper_cnn
    from repro_torch.core import losses
    from repro_torch.data.synthetic import MNIST_LIKE
    from repro_torch.experiments import runner
    from repro_torch.pytree import tree_leaves_with_path, tree_map

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = paper_cnn(MNIST_LIKE, 8, device=dev)
    C, bs = 50, 64
    params = tree_map(lambda x: x.expand((C,) + tuple(x.shape)).clone()
                      + 0.01 * torch.randn((C,) + tuple(x.shape),
                                           generator=gen, device=dev),
                      model.init(gen))
    x = torch.randn((C, bs, 28, 28, 1), generator=gen, device=dev)
    y = torch.randint(0, 10, (C, bs), generator=gen, device=dev)
    grad = torch.func.vmap(torch.func.grad(
        lambda p, a, b: losses.cross_entropy_loss(model.apply(p, a), b, 10)))
    for label, ctx in (("former", former_numerics),
                       ("deterministic", runner._deterministic_f32)):
        with ctx():
            runs = [grad(params, x, y) for _ in range(5)]
        first = tree_leaves_with_path(runs[0])
        for path, g0 in first:
            worst = max(float((dict(tree_leaves_with_path(r))[path] - g0)
                              .abs().max()) for r in runs[1:])
            name = "/".join(str(k) for k in path)
            print(f"[grads] {label}: {name} {tuple(g0.shape)} "
                  f"{'DIFFERS' if worst else 'equal'} over 5 repeats "
                  f"(max |diff| {worst:.3e}) ({card})", flush=True)


def run_turns(card: str, label: str, spec) -> bool:
    import torch
    from repro_torch.experiments import run, runner

    real = runner._deterministic_f32
    steady = {"former": [], "now": []}
    rows = {"former": [], "now": []}
    for side in ("former", "now", "now", "former") * 2:
        runner._deterministic_f32 = former_numerics if side == "former" \
            else real
        try:
            rec = run(spec, verbose=False).record
        finally:
            runner._deterministic_f32 = real
        torch.cuda.synchronize()
        rows[side].append({k: rec.get(k) for k in ROUND_KEYS})
        steady[side] += rec["round_time_s"][1:]
        print(f"[{label}] {side}: s/round "
              f"{[round(t, 4) for t in rec['round_time_s']]}, loss "
              f"{rec['global_loss']}, selected {rec['selected']} ({card})",
              flush=True)
    for side in ("former", "now"):
        same = all(r == rows[side][0] for r in rows[side][1:])
        print(f"[{label}] {side}: median steady round "
              f"{statistics.median(steady[side]):.4f} s over "
              f"{len(steady[side])}, range {min(steady[side]):.4f}-"
              f"{max(steady[side]):.4f}; records equal over "
              f"{len(rows[side])} runs: {same} ({card})", flush=True)
    return all(r == rows["now"][0] for r in rows["now"][1:])


def strict_check(card: str, specs: dict) -> bool:
    import warnings
    import torch
    from repro_torch.experiments import run, runner

    torch.use_deterministic_algorithms(True)
    real = runner._deterministic_f32
    runner._deterministic_f32 = former_numerics
    ok = True
    try:
        for label, spec in specs.items():
            rows = []
            with warnings.catch_warnings(record=True) as ws:
                warnings.simplefilter("always")
                for _ in range(2):
                    rec = run(spec, verbose=False).record
                    rows.append({k: rec.get(k) for k in ROUND_KEYS})
            same = rows[0] == rows[1]
            ok &= same
            print(f"[strict] {label}: 2 runs under the former numerics and "
                  f"use_deterministic_algorithms(True): no op raised; "
                  f"records equal: {same}; loss {rows[0]['global_loss']}, "
                  f"selected {rows[0]['selected']}; warnings "
                  f"{sorted({str(w.message)[:200] for w in ws})} ({card})",
                  flush=True)
    finally:
        runner._deterministic_f32 = real
        torch.use_deterministic_algorithms(False)
    return ok


def main() -> None:
    strict = "--strict" in sys.argv[1:]
    if strict:          # read when cuBLAS starts: before any CUDA work
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device (this probe runs on the card)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.experiments import get_scenario, override, run
    from repro_torch.kernels import runtime

    runtime.build_all(("quant_pack", "wire_agg"))
    card = card_line()
    print(card, flush=True)
    specs = {"low-bandwidth-int4": override(
                 get_scenario("low-bandwidth-int4"), "run.rounds=3"),
             "straggler-int4": override(
                 get_scenario("straggler/deadline-tight"), "run.rounds=3",
                 "comm.compressor=int4", "comm.downlink_compressor=int8")}
    run(specs["low-bandwidth-int4"], verbose=False)          # warm-up
    if strict:
        ok = strict_check(card, specs)
    else:
        grad_check(card)
        ok = all([run_turns(card, label, spec)
                  for label, spec in specs.items()])
    print(card, flush=True)
    if not ok:
        sys.exit("runs that should agree disagree")


if __name__ == "__main__":
    main()
