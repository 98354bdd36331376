"""The sharded mesh path across ranks, outside the test suite: the CPU
mesh tests' cases (tests/torch_mesh_worker.py: reduced smollm-360m,
qwen3-moe-30b-a3b with E 8 top 2 dropless, recurrentgemma-9b, f32; an
M-DSL round, a FedAvg round, a prefill, two decode steps, the shard-wise
init) on meshes of spawned ranks, each held to the port's one-process
step, plus the kernel boundary and the EP all-to-all on a 2-rank
sub-mesh. No JAX: the parity with the reference is the CPU tests'.

    python3 mesh_probe.py --backend gloo   # CPU: a (2, 2) mesh of 4
        # ranks, then (2, 1) and (1, 2) of 2, under this torch's DTensor
    python3 mesh_probe.py --backend nccl   # four cards: the (2, 2) mesh
        # over NCCL, one card a rank

Each case prints its time, launches (rank 0) and largest difference;
the exit code is 0 when every case is within TOL (the boundary's
quantize-pack, scan and Eq. 8 bitwise, the init bitwise).

The layout case, on the (2, 2) mesh: the vocab-parallel embedding
lookup (its output and table gradient) and the expert-sharded dense MoE
dispatch under the TP and FSDP rules
(`torch_mesh_worker.layout_case`), each against the one-process port on
the rank's device.

The dryrun case, on the (2, 2) mesh: each rank's cost-model counts
(`launch/op_costmodel.py`: FLOPs, HBM bytes, the arguments' bytes,
collective bytes and counts by kind, the live bytes' peak) of a reduced
smollm-360m train round and prefill and a reduced qwen3-moe-30b-a3b
prefill (both layouts above) on real tensors equal, number for number,
those of the same rank in the fake (2, 2) dry-run (`launch/dryrun.py`'s
analysis: fake tensors on a fake process group of 4 ranks, run in this
process before the ranks start)."""
import argparse
import datetime
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
CASES = [("smollm-360m", "train"), ("qwen3-moe-30b-a3b", "train"),
         ("recurrentgemma-9b", "train"), ("smollm-360m", "fedavg"),
         ("smollm-360m", "prefill"), ("qwen3-moe-30b-a3b", "prefill"),
         ("smollm-360m", "decode"), ("recurrentgemma-9b", "decode"),
         ("qwen3-moe-30b-a3b", "decode"), ("smollm-360m", "init"),
         ("qwen3-moe-30b-a3b", "init"), ("recurrentgemma-9b", "init")]


def _paths() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))


def _workers(arch: str, kind: str, mesh_shape: tuple) -> int:
    return (mesh_shape[0] if kind in ("train", "fedavg")
            and not arch.startswith("qwen3") else 1)


def dryrun_expected(mesh_shape: tuple) -> dict:
    """{(arch, kind): [each rank's counts]} of the fake dry-run."""
    import torch_mesh_worker as mw
    world = int(np.prod(mesh_shape))
    return {case: [mw.dryrun_fake(*case, mesh_shape, r)
                   for r in range(world)] for case in mw.DRYRUN}


def dryrun_check(name: str, rank: int, mesh, dev, expected: dict) -> bool:
    """This rank's real counts against its fake ones; each rank prints
    what differs, rank 0 the counts."""
    import torch_mesh_worker as mw
    ok = True
    for case, want in expected.items():
        got = mw.dryrun_real(*case, mesh, device=dev)
        diff = {k: (got[k], want[rank][k]) for k in want[rank]
                if got[k] != want[rank][k]}
        if diff or rank == 0:
            print(f"[mesh] {name} dryrun {' '.join(case)} rank {rank}: "
                  f"real {got} {'PASS' if not diff else f'FAIL {diff}'}",
                  flush=True)
        ok &= not diff
    return ok


def layout_check(name: str, rank: int, mesh, dev) -> bool:
    """The vocab-parallel lookup (forward and table gradient) and the
    expert-sharded dense dispatch (no EP; TP and FSDP rules) on this
    mesh (`torch_mesh_worker.layout_case`), against the one-process
    port on this rank's device: the lookup bitwise where the CPU tests
    hold it bitwise (`layout_exact`: gathers and F.embedding's own
    backward, deterministic on a card too); every other result, and on
    a card the dispatch (cuBLAS may pick another kernel for a batch of
    fewer experts), within TOL x max(1, the largest |value|), printing
    whether it was bitwise. Rank 0 prints and judges."""
    import torch_mesh_worker as mw
    z = mw.layout_inputs()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    got = mw.layout_case(mesh, z, device=dev)
    sync()
    dt = time.perf_counter() - t0
    if rank != 0:
        return True
    ok = True
    for region, label, rules in mw.LAYOUTS[name]:
        key = f"{region}|{label}|"
        want = mw.layout_one_process(z, region, device=dev)
        worst, good = 0.0, True
        for k, w in want.items():
            d = float(np.abs(got[key + k].astype(np.float64) - w).max())
            exact = mw.layout_exact(k, label, rules) and (
                region == "lookup" or dev.type == "cpu")
            good &= (d == 0.0 if exact
                     else d <= TOL * max(1.0, float(np.abs(w).max())))
            worst = max(worst, d)
        print(f"[mesh] {name} {region} {label} ({rules}): {dt:.3f} s for "
              f"all, max |sharded - one rank| {worst:.3e}"
              f"{' (bitwise)' if worst == 0.0 else ''}, largest tensor "
              f"on rank 0 {int(got[key + 'most'])} elements "
              f"{'PASS' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


def rank_main(rank: int, world: int, store: str, backend: str,
              mesh_shape: tuple, expected: dict) -> None:
    _paths()
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import torch_mesh_worker as mw
    from repro_torch.kernels import runtime
    from repro_torch.models import moe
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(2)
    sync = torch.cuda.synchronize if backend == "nccl" else (lambda: None)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120), **kw)
    ok = True
    name = "x".join(map(str, mesh_shape))
    try:
        mesh = init_device_mesh(dev.type, mesh_shape,
                                mesh_dim_names=("data", "model"))
        for arch, kind in CASES:
            runtime.reset_counts()
            sync()
            t0 = time.perf_counter()
            try:
                got = mw.run_step(arch, kind, mesh, device=dev)
            except Exception:        # the same on every rank: go on
                if rank == 0:
                    print(f"[mesh] {name} {arch} {kind} FAILED: "
                          f"{traceback.format_exc()[-1500:]}", flush=True)
                ok = False
                continue
            sync()
            dt = time.perf_counter() - t0
            if rank != 0:
                continue
            if kind == "init":
                good = float(got["diff"]) == 0.0 and bool(got["smaller"])
                print(f"[mesh] {name} {arch} init_placed: {dt:.3f} s, diff "
                      f"{float(got['diff'])}, {int(got['sharded'])} leaves "
                      f"sharded {'PASS' if good else 'FAIL'}", flush=True)
                ok &= good
                continue
            want = mw.one_rank(arch, kind, _workers(arch, kind, mesh_shape),
                               device=dev)
            worst = max(float(np.abs(got[k].astype(np.float64)
                                     - want[k]).max()) for k in want)
            print(f"[mesh] {name} {arch} {kind}: {dt:.3f} s, launches on "
                  f"rank 0 {runtime.counts()}, max |sharded - one rank| "
                  f"{worst:.3e} {'PASS' if worst <= TOL else 'FAIL'}",
                  flush=True)
            ok &= worst <= TOL
        if mesh_shape[0] == 2:
            sub = mesh["data"]
            res = mw.boundary_case(sub, {"seed": np.array(24)}, device=dev)
            cfg = mw.moe_cfg()
            g = torch.Generator().manual_seed(0)
            p = moe.moe_init(g, cfg, "cpu")
            x = 0.1 * torch.randn((8, 16, cfg.d_model), generator=g)
            r = torch.randn((8, 16, cfg.d_model), generator=g)
            z = {"x": x.numpy(), "r": r.numpy(),
                 "p_norm": p["norm"]["scale"].numpy(),
                 **{f"p_{k}": p[k].numpy()
                    for k in ("router", "wi", "wu", "wo")}}
            ep = mw.moe_ep_case(sub, z, device=dev)
            if rank == 0:
                for kern in ("flash", "scan", "pso", "wire"):
                    want = res[f"{kern}_want"]
                    for k in sorted(res):
                        if k.startswith(kern + "_") and k != f"{kern}_want":
                            d = float(np.abs(res[k].astype(np.float64)
                                             - want).max())
                            good = d <= (TOL if kern == "flash" else 0.0)
                            print(f"[mesh] {name} boundary {k}: max diff "
                                  f"{d:.3e} {'PASS' if good else 'FAIL'}",
                                  flush=True)
                            ok &= good
                print(f"[mesh] {name} boundary gathers "
                      f"{dict(zip(res['counts_names'].tolist(), res['counts'].tolist()))}",
                      flush=True)
                y, aux = moe.moe_apply(p, x, cfg)
                d = float(np.abs(ep["y"] - y.detach().numpy()).max())
                print(f"[mesh] {name} EP all-to-all (2 shards) against the "
                      f"dense dispatch: y {d:.3e}, aux "
                      f"{abs(float(ep['aux']) - float(aux)):.3e} "
                      f"{'PASS' if d <= TOL else 'FAIL'}", flush=True)
                ok &= d <= TOL
        if mesh_shape == (2, 2):
            ok &= layout_check(name, rank, mesh, dev)
        if expected:
            ok &= dryrun_check(name, rank, mesh, dev, expected)
        dist.barrier()
    except Exception:
        traceback.print_exc()
        ok = False
    finally:
        dist.destroy_process_group()
    if not ok:
        sys.exit(1)


def run(backend: str, mesh_shape: tuple, store_dir: str) -> bool:
    import torch.multiprocessing as mp
    world = int(np.prod(mesh_shape))
    store = f"{store_dir}/store-{'x'.join(map(str, mesh_shape))}"
    expected = dryrun_expected(mesh_shape) if mesh_shape == (2, 2) else {}
    try:
        mp.start_processes(rank_main, args=(world, store, backend,
                                            mesh_shape, expected),
                           nprocs=world, join=True, start_method="spawn")
    except Exception as e:
        print(f"[mesh] {mesh_shape} ranks failed: {e}", flush=True)
        return False
    return True


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    args = ap.parse_args()
    _paths()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    if args.backend == "nccl":
        if torch.cuda.device_count() < 4:
            sys.exit(f"mesh_probe: --backend nccl needs 4 cards, this host "
                     f"has {torch.cuda.device_count()}")
        from repro_torch.kernels import runtime
        t0 = time.perf_counter()
        runtime.build_all()
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    meshes = [(2, 2)] + ([(2, 1), (1, 2)] if args.backend == "gloo" else [])
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        ok = all([run(args.backend, m, d) for m in meshes])
    print("[mesh] ALL PASS" if ok else "[mesh] FAILED", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
