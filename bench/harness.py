"""One run of one cell: set-up, the timed window, the traced rounds, the
check against the plain reference, and the result line. Everything that
belongs to a cell is found by name: `BENCHMARK.json` at the repository's
root, `bench/workloads/<cell>.json` (with its traffic mix),
`bench/configs/<config>.json`, `bench/engines/<engine>.py`,
`bench/metrics/<metric>.py`."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, NamedTuple, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str) -> dict:
    """bench/<kind>/<name>.json."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def entry(bm: dict, name: str) -> dict:
    for w in bm["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bm: dict, name: str, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it, and those that list no cells."""
    return [m for m in bm[kind]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    """bench/metrics/<metric>.py's `read`."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{metric.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_start() -> float:
    """This process's start, in time.time() seconds."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        for line in Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime"):
                return int(line.split()[1]) + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Context(NamedTuple):
    """What a per-layer metric reads."""
    trace: Any                 # bench.trace.Trace or None
    round_s: float             # the untraced window's seconds a round
    step_host_s: list          # host seconds inside Prepared.step a round
    flops_per_round: int
    peak_flops: float
    launches: dict             # kernel -> [(operations, bytes, dtype)]
    counts: dict               # the program's launch counters, traced


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced(engine, rounds: int, device) -> tuple[Any, dict]:
    """`rounds` rounds under torch.profiler, each in a `bench.round`
    range: (the reduced trace, the program's launch counts in them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import runtime
    from bench import trace
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = runtime.counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=acts) as prof:
            for _ in range(rounds):
                with record_function(trace.ROUND):
                    engine.round()
            _sync(device)
        prof.export_chrome_trace(path)
        del prof
        tr = trace.load(path)
    after = runtime.counts()
    counts = {k: n - before.get(k, 0) for k, n in after.items()}
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return tr, counts


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", cell: Optional[dict] = None,
             config: Optional[dict] = None, bm: Optional[dict] = None,
             t_start: Optional[float] = None) -> dict:
    """One run of cell `name`; returns the result line's dict. `cell`,
    `config` and `bm` replace what would be loaded by name (tests)."""
    import torch
    from bench import trace as trace_mod
    from bench.costs.peaks import FLOPS_PER_S
    t_start = process_start() if t_start is None else t_start
    bm = benchmark() if bm is None else bm
    cell = load_json("workloads", name) if cell is None else cell
    cfg = load_json("configs", cell["config"]) if config is None else config
    dev = torch.device(device)
    engine = importlib.import_module(
        f"bench.engines.{cell['engine']}").Engine(cell, cfg, seed, dev)
    t_engine = time.time()
    engine.setup()
    _sync(dev)
    setup_s = time.time() - t_start
    print(f"[bench] set-up {setup_s:.2f} s: to the engine "
          f"{t_engine - t_start:.2f} s, the engine's "
          + ", ".join(f"{k} {v:.2f} s" for k, v in engine.timings.items()),
          file=sys.stderr)
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    losses, steps, ends = [], [], []
    t0 = time.perf_counter()
    while True:
        loss, step_s = engine.round()
        losses.append(loss)
        steps.append(step_s)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    window_s = ends[-1]
    print("[bench] window: round ends (s) "
          + " ".join(f"{t:.3f}" for t in ends), file=sys.stderr)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    round_s = window_s / len(losses)
    tr, counts = (_traced(engine, cell["trace"]["rounds"], dev) if traced
                  else (None, {}))
    flops, launches = engine.flops_per_round(), engine.launches()
    rates = {k: n / round_s for k, n in engine.rates().items()}
    engine.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.time()
    found = engine.check()
    print(f"[bench] check: the reference {time.time() - t_check:.2f} s",
          file=sys.stderr)
    limits = cell["check"]["limits"]
    checks = {k: {"value": found[k][0], "limit": limits[k], "at": found[k][1]}
              for k in limits}
    failed = sum(1 for x in losses if not math.isfinite(x))
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    if traced:
        ctx = Context(trace=tr, round_s=round_s, step_host_s=steps,
                      flops_per_round=flops,
                      peak_flops=FLOPS_PER_S[cfg["precision"]],
                      launches=launches, counts=counts)
        metrics = {}
        for m in metrics_for(bm, name, "per_layer"):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(rates, round_s=round_s, setup_s=setup_s,
                   peak_mem_gib=window_peak / 2**30)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in metrics_for(bm, name, "end_to_end")}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1,
        "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": correct, "attempted": len(losses), "failed": failed,
           "metrics": metrics, "device": device_info}
    if traced and tr is not None:
        device_info["busy_s"] = trace_mod.busy_s(tr)
        device_info["window_s"] = tr.window_s
        top = sorted(trace_mod.by_name(tr).items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top[:10]],
                            "idle_gaps": trace_mod.idle_gaps(tr)}
    out["checks"] = checks
    return out
