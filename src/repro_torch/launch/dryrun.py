"""Multi-pod dry-run (the JAX package's `launch/dryrun.py`): every (arch x
input shape x mesh) step costed for one rank of a 256-rank (one pod,
16 x 16) or 512-rank (two pods, 2 x 16 x 16) mesh, with no card and no
cluster, written as JSON records to
`artifacts/dryrun_torch/<arch>__<shape>__<mesh><tag>.json`.

The reference lowers and compiles `build_step` on placeholder devices and
reads XLA's memory and cost analyses and the HLO. The port has no
compiler: `run_one` initialises a fake process group of 256 or 512 ranks
(`torch.distributed`'s "fake" backend: collectives return at once) inside
the call and tears it down after, builds `make_production_mesh` and
`launch/steps.build_step` on it, makes each argument a fake DTensor
(`FakeTensorMode`: shapes, no storage) whose local shard is rank 0's
shard of its `layouts` entry, and runs the step under the cost model
(`launch/op_costmodel.py`), which counts what rank 0 dispatches. The
kernels run their shape rules (`runtime.register_op`'s fake
implementations). The fake tensors are on "cuda" where PyTorch has CUDA
and on "cpu" elsewhere (a CPU-only build cannot index a CUDA tensor,
even a fake one); the counts do not depend on it.

The record keeps the reference's keys, with these counterparts:
`trace_s` for `lower_s` and `compile_s`, `ops_path` (the gzipped op
table, `launch/profile.py`'s input) for `hlo_path`; `xla_cost`,
`generated_code_bytes` and `max_while_trip` have none (no compiler, no
while loops: see op_costmodel). `memory` adds `peak_bytes`, and the
record the peak's breakdown and the data-dependent reads.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-done]
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k \\
      --scenario rayleigh-uplink   # CommConfig from the registry
  python -m repro_torch.launch.dryrun --reanalyze   # from the op tables
"""
from __future__ import annotations

import argparse
import gzip
import json
import time
import traceback
from pathlib import Path
from typing import Any

import torch

from repro_torch.configs.base import INPUT_SHAPES, get_arch, list_archs
from repro_torch.launch import op_analysis, op_costmodel
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.pytree import tree_flatten, tree_leaves, tree_unflatten

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
WORLD = {"single": 256, "multi": 512}


def model_flops_per_device(cfg, shape, n_dev: int) -> float:
    """Analytic MODEL_FLOPS (6*N_active*D train / 2*N_active*D fwd) for
    the tokens this step processes, per device."""
    tok = shape.global_batch * (shape.seq_len
                                if shape.kind != "decode" else 1)
    mult = 3 if shape.kind == "train" else 1  # fwd+bwd vs fwd
    if shape.kind == "train":
        tok += 16 * 4 * shape.seq_len  # W * EVAL_BATCH scoring fwd (approx)
    return 2 * cfg.active_param_count() * tok * mult / n_dev


def analyze(summary: dict, cfg, shape, n_dev: int) -> dict:
    """The record's roofline fields from the cost model's (or a saved op
    table's) totals."""
    mf = model_flops_per_device(cfg, shape, n_dev)
    return {
        "flops_per_device": summary["flops"],
        "hbm_bytes_per_device": summary["hbm_bytes"],
        "collectives": summary["collectives"],
        "roofline": op_analysis.roofline(
            summary["flops"], summary["hbm_bytes"],
            summary["collectives"]["total_bytes"], mf, fma_counted=False),
    }


def pair_is_applicable(arch_name: str, shape_name: str) -> tuple[bool, str]:
    cfg = get_arch(arch_name)
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: long_500k skipped per brief "
                       "(DESIGN.md §4)")
    return True, ""


def fake_args(built, mesh, device) -> tuple:
    """`built.args` as fake tensors (inside the caller's FakeTensorMode):
    a leaf with a Layout becomes a DTensor whose local shard is this
    rank's box of it, one without (the draws) a plain tensor. A meta leaf
    that two fields share (the state's best and current params) stays
    one tensor."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.steps import _box
    memo: dict[int, Any] = {}

    def make(x, lay):
        if not torch.is_tensor(x):
            return x
        if id(x) not in memo:
            if lay is None:
                memo[id(x)] = torch.empty(x.shape, dtype=x.dtype,
                                          device=device)
            else:
                box = _box(tuple(x.shape), lay.placements, mesh)
                local = torch.empty(tuple(e - b for b, e in box),
                                    dtype=x.dtype, device=device)
                memo[id(x)] = DTensor.from_local(local, mesh, lay.placements,
                                                 run_check=False)
        return memo[id(x)]

    out = []
    for arg, lays in zip(built.args, built.layouts + (None,) * (
            len(built.args) - len(built.layouts))):
        leaves, treedef = tree_flatten(arg)
        lay = (tree_leaves(lays) if lays is not None
               else [None] * len(leaves))
        if len(lay) != len(leaves):
            raise ValueError(f"{len(leaves)} leaves against {len(lay)} "
                             f"layouts")
        out.append(tree_unflatten(treedef, [make(x, l)
                                            for x, l in zip(leaves, lay)]))
    return tuple(out)


def arg_parts(built, args) -> list[tuple[str, Any]]:
    """(label, tree) pieces of the step's arguments for the memory
    breakdown: each field of the train step's state, then the batches
    and draws; a serve step's params, inputs and cache."""
    names = (("state", "batch", "eval_batch", "draws")
             if built.meta.get("mode") is None
             else ("params", "inputs", "cache"))
    parts = []
    for name, a in zip(names, args):
        if hasattr(a, "_fields"):
            parts += [(f"{name}.{f}", getattr(a, f)) for f in a._fields]
        else:
            parts.append((name, a))
    return parts


def dry_run(built, mesh, device) -> tuple[dict, list[dict], float]:
    """Cost one rank of `built`'s step on `mesh` with fake tensors: (the
    cost model's summary, its op table, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        args = fake_args(built, mesh, device)
        out, cm = op_costmodel.count_step(built.fn, args,
                                          parts=arg_parts(built, args),
                                          fake_mode=fm)
        summary = cm.summary(out)
    return summary, cm.op_table(), time.time() - t0


def forget_meshes() -> None:
    """Drop DTensor's caches of sharding decisions: they key on a mesh's
    shape and names, not on its process group, so after a group is torn
    down they would hand its (destroyed) meshes to the next group's
    DTensors. Called whenever a dry-run's fake group ends."""
    from torch.distributed.tensor import debug
    from torch.distributed.tensor import _redistribute
    if hasattr(debug, "_clear_sharding_prop_cache"):
        debug._clear_sharding_prop_cache()
    else:
        from torch.distributed.tensor import DTensor
        DTensor._op_dispatcher.sharding_propagator \
            .propagate_op_sharding.cache_clear()
    if hasattr(_redistribute, "clear_redistribute_planner_cache"):
        _redistribute.clear_redistribute_planner_cache()


def _jsonable(meta: dict) -> dict:
    out = {}
    for k, v in meta.items():
        v = list(v) if isinstance(v, tuple) else v
        try:
            json.dumps(v)
        except TypeError:
            continue
        out[k] = v
    return out


def run_one(arch_name: str, shape_name: str, mesh_kind: str,
            algorithm: str = "mdsl", save_ops: bool = True,
            tag: str = "", comm=None) -> dict:
    """`comm` (a repro_torch.comm.CommConfig, default wire when None)
    threads compression/robust-aggregation/downlink configs into the
    step, so comm scenarios cost out on the 512-rank model. The fake
    process group lives for this call only; a failure is recorded."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = get_arch(arch_name)
    shape = INPUT_SHAPES[shape_name]
    world = WORLD[mesh_kind]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
           "algorithm": algorithm, "devices": world, "ok": False, "tag": tag,
           "fake_device": device}
    if comm is not None:
        rec["comm"] = comm._asdict()
    t0 = time.time()
    if dist.is_initialized():
        raise RuntimeError("dryrun.run_one starts its own fake process "
                           "group; one is initialised already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type=device)
        built = build_step(cfg, shape, mesh, algorithm=algorithm, comm=comm)
        summary, table, trace_s = dry_run(built, mesh, device)
        rec.update(
            ok=True, trace_s=round(trace_s, 1),
            memory=summary["memory"],
            **analyze(summary, built.cfg, shape, world),
            peak_breakdown=summary["peak_breakdown"],
            data_dependent=summary["data_dependent"],
            meta=_jsonable(built.meta))
        if save_ops:
            ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
            opath = ARTIFACT_DIR / (f"{arch_name}__{shape_name}__"
                                    f"{mesh_kind}{tag}.ops.json.gz")
            with gzip.open(opath, "wt") as f:
                json.dump(table, f)
            rec["ops_path"] = str(opath)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    finally:
        dist.destroy_process_group()
        forget_meshes()
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def artifact_path(arch: str, shape: str, mesh_kind: str, tag: str = "") -> Path:
    return ARTIFACT_DIR / f"{arch}__{shape}__{mesh_kind}{tag}.json"


def reanalyze_all(tag: str = "") -> None:
    """Recompute the roofline record of every artifact from its saved op
    table (no re-trace) — used after cost-model changes."""
    for jpath in sorted(ARTIFACT_DIR.glob(f"*{tag}.json")):
        rec = json.loads(jpath.read_text())
        if not rec.get("ok"):
            continue
        opath = Path(str(jpath)[: -len(".json")] + ".ops.json.gz")
        if not opath.exists():
            print(f"no op table for {jpath.name}, skipping")
            continue
        with gzip.open(opath, "rt") as f:
            table = json.load(f)
        cfg = get_arch(rec["arch"])
        shape = INPUT_SHAPES[rec["shape"]]
        rec.update(analyze(op_costmodel.summary_from_table(table), cfg,
                           shape, WORLD[rec["mesh"]]))
        jpath.write_text(json.dumps(rec, indent=1))
        print(f"reanalyzed {jpath.name}: "
              f"dominant={rec['roofline']['dominant']} "
              f"useful={rec['roofline']['useful_flops_ratio']:.2f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--algorithm", default="mdsl")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--tag", default="", help="artifact suffix for perf variants")
    ap.add_argument("--scenario", default=None,
                    help="resolve the CommConfig from this registry "
                         "scenario (one flag surface for comm pricing — "
                         "fading/outage/tier scenarios included)")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute rooflines from saved op tables (no "
                         "re-trace)")
    args = ap.parse_args()

    if args.reanalyze:
        reanalyze_all(args.tag)
        return

    comm = None
    if args.scenario:
        from repro_torch.experiments.registry import get_scenario
        comm = get_scenario(args.scenario).comm
        if not args.tag:
            args.tag = "__" + args.scenario.replace("/", "-")

    archs = ([a for a in list_archs()] if args.all or not args.arch
             else [args.arch])
    shapes = (list(INPUT_SHAPES) if args.all or not args.shape
              else [args.shape])
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                ok, why = pair_is_applicable(arch, shape)
                path = artifact_path(arch, shape, mesh_kind, args.tag)
                if not ok:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "skipped": True, "reason": why}
                    path.write_text(json.dumps(rec, indent=1))
                    print(f"SKIP {arch} {shape} {mesh_kind}: {why}")
                    continue
                if args.skip_done and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("ok") or prev.get("skipped"):
                        print(f"DONE {arch} {shape} {mesh_kind} (cached)")
                        continue
                print(f"RUN  {arch} {shape} {mesh_kind} ...", flush=True)
                rec = run_one(arch, shape, mesh_kind, algorithm=args.algorithm,
                              tag=args.tag, comm=comm)
                path.write_text(json.dumps(rec, indent=1))
                status = "ok" if rec.get("ok") else f"FAIL {rec.get('error')}"
                print(f"     -> {status} ({rec['total_s']}s)", flush=True)


if __name__ == "__main__":
    main()
