#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (src/repro_torch).

    python3 chip_smoke.py            # needs one CUDA card, nvcc, the repo

Phases (any failure exits non-zero; no phase catches its own failure):

  1. builds the CUDA kernels from src/repro_torch/csrc (one nvcc per
     source, in parallel) and prints the build seconds;
  2. prints the card's name and power limit (nvidia-smi);
  3. holds each kernel against its plain PyTorch version on CUDA tensors,
     int8 and int4, at the main path's shapes (C = 50 workers, one
     (256, 128) block per CNN5 leaf; the downlink at C = 1) and at one
     large leaf (2^20 elements x C = 50), every wire_agg mode with partial
     and all-lost masks; prints max errors and median CUDA-event times;
  4. checks the engine on a small input: one round on the card against
     the same round on the CPU (plain versions), same data and draws;
  5. drives the main path: `repro_torch.experiments.run` on the
     `low-bandwidth-int4` scenario (C = 50, CNN5 width 8, int4 uplink,
     int8 downlink) for 3 rounds with the launch counts reset just before
     and read just after; every kernel must have launched 10 leaves x 3
     rounds = 30 times;
  6. prints the `kernels` JSON line and, last, the ok line.

Tolerances: payloads, scales, decodes and the wire_agg median bitwise;
the error-feedback residual within 1 ulp of |acc| (fmaf in the kernel,
one rounding from f64 in the plain version); wire_agg mean, sum and
trimmed mean within 2^-21 * sum|terms| (both sum in the same order, so
this is expected to be 0).
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
SUM_RTOL = 2.0 ** -21
ROUNDS, LEAVES = 3, 10
MAIN_BITS = {"quant_pack_ef": 4, "wire_agg": 4, "quant_pack": 8,
             "dequant_unpack": 8}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, reps: int) -> float:
    """Median over `reps` calls, each between two CUDA events: the time
    one eager call holds the device's queue, host launch gap included."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps: int) -> float:
    """Device time per launch: `reps` launches captured in one CUDA graph,
    replayed between two CUDA events — no host launch gap in between."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ulp(x):
    import torch
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def kernel_checks(dev):
    """Phase 3. Returns {kernel: {max_abs_err, ms, plain_ms, bound_ms,
    bound_by}} at the main path's shapes."""
    import torch
    from repro_torch.kernels.quant_pack import ops as qops
    from repro_torch.kernels.quant_pack import ref as qref
    from repro_torch.kernels.wire_agg import ops as wops
    from repro_torch.kernels.wire_agg import ref as wref

    g = torch.Generator(device=dev).manual_seed(0)
    out = {k: {"max_abs_err": 0.0} for k in
           ("quant_pack_ef", "wire_agg", "quant_pack", "dequant_unpack")}

    def err(name, got, want):
        e = float((got.float() - want.float()).abs().max())
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)
        return e

    def seeds(C):
        return torch.randint(0, 2**31 - 1, (C,), generator=g, device=dev,
                             dtype=torch.int32)

    shapes = {"main": 256, "large": 8192}        # rows per worker leaf
    for bits in (8, 4):
        for label, rows in shapes.items():
            C = 50
            x = 0.01 * torch.randn((C, rows, 128), generator=g, device=dev)
            r = 0.001 * torch.randn((C, rows, 128), generator=g, device=dev)
            x[0, :256] = 0.0
            x[1, :256], r[1, :256] = 0.0, 0.0      # all-zero block
            s = seeds(C)
            # quant_pack_ef
            kp, ks, kr = qops.quant_pack_ef_2d(x, r, s, bits=bits)
            pp, ps, pr = qref.quant_pack_ef_ref(x, r, s, bits=bits)
            torch.cuda.synchronize()
            check(torch.equal(kp, pp), f"quant_pack_ef payload bits={bits} "
                                       f"{label}")
            check(torch.equal(ks, ps), f"quant_pack_ef scales bits={bits}")
            err("quant_pack_ef", ks, ps)
            e = err("quant_pack_ef", kr, pr)
            check(bool(((kr - pr).abs() <= ulp(x + r)).all()),
                  f"quant_pack_ef residual > 1 ulp (max {e}) bits={bits}")
            # quant_pack (downlink: C = 1 on the main path)
            for Cq in ((1, C) if label == "main" else (C,)):
                xq, sq = x[:Cq].contiguous(), s[:Cq].contiguous()
                kq, kqs = qops.quant_pack_2d(xq, sq, bits=bits)
                pq, pqs = qref.quant_pack_ref(xq, sq, bits=bits)
                torch.cuda.synchronize()
                check(torch.equal(kq, pq) and torch.equal(kqs, pqs),
                      f"quant_pack bits={bits} C={Cq} {label}")
                err("quant_pack", kqs, pqs)
                # dequant_unpack
                kd = qops.dequant_unpack_2d(pq, pqs, bits=bits)
                pd = qref.dequant_unpack_ref(pq, pqs, bits=bits)
                torch.cuda.synchronize()
                check(torch.equal(kd, pd), f"dequant_unpack bits={bits} "
                                           f"C={Cq} {label}")
                err("dequant_unpack", kd, pd)
            # wire_agg: every mode, partial / all-lost masks, weights
            d = qref.dequant_unpack_ref(pp, ps, bits=bits)
            part = (torch.rand(C, generator=g, device=dev) > 0.3).float()
            w = torch.rand(C, generator=g, device=dev) + 0.5
            for mask_name, mask, wts in (
                    ("partial", part, torch.ones(C, device=dev)),
                    ("weighted", part, w),
                    ("all-lost", torch.zeros(C, device=dev), w)):
                for agg in ("mean", "sum", "median", "trimmed_mean"):
                    ka = wops.wire_agg_2d(pp, ps, mask, wts, bits=bits,
                                          aggregator=agg, trim_ratio=0.2)
                    pa = wref.wire_agg_ref(pp, ps, mask, wts, bits=bits,
                                           aggregator=agg, trim_ratio=0.2)
                    torch.cuda.synchronize()
                    e = err("wire_agg", ka, pa)
                    if agg == "median" or mask_name == "all-lost":
                        ok = torch.equal(ka, pa)
                    else:
                        tol = SUM_RTOL * (d.abs() * wts.reshape(C, 1, 1)
                                          ).sum(0)
                        ok = bool(((ka - pa).abs() <= tol).all())
                    check(ok, f"wire_agg {agg} {mask_name} bits={bits} "
                              f"{label}: max err {e}")
            print(f"[check] bits={bits} {label} (C=50, rows={rows}): "
                  f"all four kernels match their plain versions", flush=True)

            # timings: device time per launch (CUDA graph replay), one
            # eager call (host launch gap included), the plain version
            n, nb = C * rows * 128, rows // 256
            pbytes = n if bits == 8 else n // 2
            x1, s1 = x[:1].contiguous(), s[:1].contiguous()
            n1 = rows * 128
            pb1 = n1 if bits == 8 else n1 // 2
            q1, q1s = qref.quant_pack_ref(x1, s1, bits=bits)
            one = torch.ones(C, device=dev)
            # name: (kernel call, plain call, workers, bytes moved, ops)
            cases = {
                "quant_pack_ef": (
                    lambda: qops.quant_pack_ef_2d(x, r, s, bits=bits),
                    lambda: qref.quant_pack_ef_ref(x, r, s, bits=bits), C,
                    8 * n + 4 * C + pbytes + 4 * C * nb + 4 * n, 25 * n),
                "wire_agg": (
                    lambda: wops.wire_agg_2d(pp, ps, part, one, bits=bits),
                    lambda: wref.wire_agg_ref(pp, ps, part, one, bits=bits),
                    C, pbytes + 4 * C * nb + 8 * C + 4 * n1, 3 * n),
                "quant_pack": (
                    lambda: qops.quant_pack_2d(x1, s1, bits=bits),
                    lambda: qref.quant_pack_ref(x1, s1, bits=bits), 1,
                    4 * n1 + 4 + pb1 + 4 * nb, 23 * n1),
                "dequant_unpack": (
                    lambda: qops.dequant_unpack_2d(q1, q1s, bits=bits),
                    lambda: qref.dequant_unpack_ref(q1, q1s, bits=bits), 1,
                    pb1 + 4 * nb + 4 * n1, 2 * n1),
            }
            for name, (kern, plain, workers, nbytes, ops) in cases.items():
                t = {"ms": graph_ms(kern, 20), "eager_ms": time_ms(kern, 50),
                     "plain_ms": time_ms(plain, 5)}
                bnd, by = bound_ms(nbytes, ops)
                print(f"[time] {name} bits={bits} {label} C={workers} "
                      f"rows={rows}: device {t['ms']:.5f} ms/launch, eager "
                      f"call {t['eager_ms']:.4f} ms, plain "
                      f"{t['plain_ms']:.4f} ms, bound {bnd:.3g} ms ({by}, "
                      f"{nbytes} B)", flush=True)
                # the main path: int4 uplink + aggregate at C = 50, int8
                # downlink at C = 1, one block per leaf
                if label == "main" and bits == MAIN_BITS[name]:
                    out[name].update(t, bound_ms=bnd, bound_by=by)
    print("[check] max abs err vs plain (all shapes, both widths): " +
          ", ".join(f"{k} {v['max_abs_err']:.3g}" for k, v in out.items()),
          flush=True)
    return out


def small_round_check(dev):
    """Phase 4: one small round on the card (kernels) against the same
    round on the CPU (plain versions), same data, init and draws."""
    import torch
    from repro_torch.bridge import tree_to_numpy
    from repro_torch.experiments import build, get_scenario, override
    from repro_torch.pytree import tree_leaves, tree_map

    spec = override(get_scenario("low-bandwidth-int4"), "data.num_workers=4",
                    "model.width_mult=2", "data.n_local=64",
                    "algo.local_epochs=1", "run.rounds=1")
    cpu = build(spec, device="cpu")
    data = tree_map(lambda t: t.cpu().numpy(), tuple(cpu.aux["data"]))
    gpu = build(spec, device=dev,
                data=type(cpu.aux["data"])(*data),
                init_params=tree_to_numpy(cpu.state.global_params))
    draws = cpu.draw(cpu.state)
    gdraws = type(draws)(*[None if v is None else
                           (tree_map(lambda t: t.to(dev), v))
                           for v in draws])
    cs, ctel = cpu.step(cpu.state, draws)
    gs, gtel = gpu.step(gpu.state, gdraws)
    check(torch.equal(ctel.mask, gtel.mask.cpu()), "small round: masks")
    # one int4 uplink level of the largest worker move over the delivered
    # count, plus one int8 downlink level of the global move: a 1e-7
    # difference from the convolutions can flip one stochastic rounding
    delivered = max(float(ctel.delivered), 1.0)
    worst, diffs = 0.0, []
    for c, gl, c0, w1, w0 in zip(tree_leaves(cs.global_params),
                                 tree_leaves(gs.global_params),
                                 tree_leaves(cpu.state.global_params),
                                 tree_leaves(cs.workers.params),
                                 tree_leaves(cpu.state.workers.params)):
        diff = (gl.cpu() - c).abs()
        tol = (float((w1 - w0).abs().max()) / 7.0 / delivered
               + float((c - c0).abs().max()) / 127.0 + 1e-5)
        worst = max(worst, float(diff.max()) / tol)
        diffs.append(diff.reshape(-1))
    mean = float(torch.cat(diffs).mean())
    check(worst <= 1.0 and mean <= 1e-5,
          f"small round: card vs CPU global params off (worst/tol "
          f"{worst:.3f}, mean {mean:.2e})")
    print(f"[small] one round C=4 w2 card vs CPU: masks equal, global "
          f"params mean |diff| {mean:.3e}, worst/tol {worst:.3f}",
          flush=True)


def profile_round(spec) -> None:
    """One more round of the main path under torch.profiler, after the
    counted run: the device's busy share of the round and its device
    time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.experiments import build

    prep = build(spec)
    state, _ = prep.step(prep.state, prep.draw(prep.state))    # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = prep.step(state, prep.draw(state))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    names = ("LocalUpdate", "ScoreSelect", "Uplink", "Aggregate",
             "Downlink", "BestTracking")
    # device-side rows only (kernels, copies): the host ops' rows repeat
    # the device time of the kernels they launched, and the stage ranges
    # also appear on the device timeline as annotations spanning them
    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
                   and e.key not in names),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    ours = sum(dev_us(e) for e in rows
               if e.key.startswith(("void (anonymous namespace)::quant_pack",
                                    "void (anonymous namespace)::dequant",
                                    "void (anonymous namespace)::wire_agg",
                                    "quant_pack", "dequant", "wire_agg"))) / 1e3
    print(f"[profile] one round: wall {wall_ms:.2f} ms (profiler on), device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"wire kernels {ours:.3f} ms, {sum(e.count for e in rows)} device "
          f"ops of {len(rows)} kinds", flush=True)
    # the host-side range of each stage: its wall time on the host and
    # the device time of the kernels it launched
    stages = {e.key: e for e in prof.key_averages()
              if e.key in names and str(e.device_type).endswith("CPU")}
    print("[profile] stages (host ms / device ms of its kernels): " + ", ".join(
        f"{k} {stages[k].cpu_time_total / 1e3:.2f}/"
        f"{getattr(stages[k], 'device_time_total', 0.0) / 1e3:.2f}"
        for k in names if k in stages), flush=True)
    for e in rows[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (this smoke test runs on the card)")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.experiments import get_scenario, override, run
        from repro_torch.kernels import runtime
        from repro_torch.pytree import tree_leaves
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda", 0)
    # the reference computes in f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    runtime.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(runtime.SOURCES)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)

    stats = kernel_checks(dev)
    small_round_check(dev)

    spec = override(get_scenario("low-bandwidth-int4"),
                    f"run.rounds={ROUNDS}")
    runtime.reset_counts()
    t0 = time.perf_counter()
    result = run(spec)
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    rec = result.record
    for t in range(ROUNDS):
        print(f"[main] round {t + 1}: {rec['round_time_s'][t]:.4f} s "
              f"loss={rec['global_loss'][t]:.5f} acc={rec['acc'][t]:.4f} "
              f"selected={rec['selected'][t]}/{rec['num_workers']}",
              flush=True)
    print(f"[main] {ROUNDS} rounds of low-bandwidth-int4 (C=50, cnn5 w8, "
          f"{rec['n_params']} params) in {wall:.2f} s incl. setup; "
          f"launches {counts}", flush=True)
    check(all(math.isfinite(v) for v in rec["global_loss"]), "loss finite")
    check(all(0.0 <= v <= 1.0 for v in rec["acc"]), "acc in [0, 1]")
    leaves = tree_leaves(result.state.global_params)
    check(len(leaves) == LEAVES and rec["n_params"] == 29018,
          f"cnn5 w8 has {len(leaves)} leaves, {rec['n_params']} params")
    check(all(bool(torch.isfinite(v).all()) for v in leaves),
          "global params finite")
    want = ROUNDS * LEAVES
    for name in stats:
        check(counts.get(name, 0) == want,
              f"{name} launched {counts.get(name, 0)} times on the main "
              f"path, expected {want}")

    profile_round(spec)

    src = {"quant_pack_ef": ("quant_pack",
                             "src/repro/kernels/quant_pack/quant_pack.py:172"),
           "wire_agg": ("wire_agg",
                        "src/repro/kernels/wire_agg/wire_agg.py:125"),
           "quant_pack": ("quant_pack",
                          "src/repro/kernels/quant_pack/quant_pack.py:120"),
           "dequant_unpack": ("quant_pack",
                              "src/repro/kernels/quant_pack/quant_pack.py:222")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src[name][0]}.cu",
                "replaces": src[name][1], "launches": counts[name],
                "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": None,
                "eager_ms": s["eager_ms"], "check": "pass"}
               for name, s in stats.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
