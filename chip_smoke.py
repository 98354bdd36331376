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
     rounds = 30 times; then profiles one more round;
  6. the serve slice's kernels against their plain versions on the card:
     flash_attention at the RecurrentGemma-9B prefill shape (B 4, S 4096,
     16 heads over 1 kv head, hd 256, window 2048, bf16), at a ragged
     shape (q_offset > 0, kv_len < Sk, fully masked rows) and in f32;
     rglru_scan at (4, 4096, 4096) f32; device, eager, plain and library
     (SDPA for flash) times and the bounds;
  7. a small serve check: reduced recurrentgemma-9b in f32, prompt 96
     (past its window of 64), on the card against the CPU from the same
     params (through the bridge): logits and greedy tokens;
  8. drives the serve path: `repro_torch.launch.serve.serve` on
     recurrentgemma-9b at full width (reduced=False, random weights from
     a seed), batch 4, prompt 4096, gen 32, counts reset just before and
     read just after: each prefill launches flash_attention 12 times and
     rglru_scan 26 times, decode neither (a warm-up pass and the timed
     pass: 24 and 52 in all); then profiles one more prefill and one
     decode step;
  9. the mesh slice's kernels against their plain versions on the card:
     pso_update (Eq. 8) bitwise in f32 and bf16, clip on and off, at the
     largest SmolLM-360M leaf stacked over W = 2 (2 x 32 x 960 x 2560)
     and at a ragged leaf; the flash backward against
     `attention_bwd_ref` and against autograd of `attention_ref` at the
     SmolLM shape (B 2, S 2048, 15 heads over 5, hd 64, causal) in bf16
     and f32 and at a windowed, ragged GQA shape; device, eager, plain
     and library times (SDPA forward + backward for the backward) and
     the bounds;
 10. a small mesh check: two M-DSL rounds of reduced smollm-360m in f32
     (W = 2) on the card against the same rounds on the CPU, same
     params, batches and draws;
 11. drives the mesh training path: `repro_torch.experiments.run` on
     `mesh/smollm-smoke` at full width (reduced=False, seq_len 2048, W
     2, B 2, bf16, random weights from a seed) for 3 rounds, counts
     reset just before and read just after: per round flash_attention
     launches 32 layers x (2 workers x 2 (forward, remat recompute) + 3
     evaluations) = 224 times, its backward 32 x 2 = 64 times and
     pso_update once per leaf, 11 times; then profiles one more round;
 12. prints the card line, the `kernels` JSON line and, last, the ok
     line.

Tolerances: payloads, scales, decodes and the wire_agg median bitwise;
the error-feedback residual within 1 ulp of |acc| (fmaf in the kernel,
one rounding from f64 in the plain version); wire_agg mean, sum and
trimmed mean within 2^-21 * sum|terms| (both sum in the same order, so
this is expected to be 0). flash_attention in bf16 within 2 bf16 ulps of
the plain output (the ulp taken at no less than 2^-16 of the largest
output), in f32 within 1e-5 of the largest output; rglru_scan bitwise;
the small serve's logits within 5e-4 (as the CPU parity tests) and its
greedy tokens equal. pso_update bitwise. The flash backward: in f32
within 1e-5 of the largest |gradient| against both references; in bf16
within 2 bf16 ulps of `attention_bwd_ref` (the ulp taken at no less than
2^-12 of the largest gradient), and within 4 bf16 ulps of the largest
|gradient| against autograd of `attention_ref` (which forms
rowsum(dO * O) from the f32 output, the kernel from the bf16 one). The
small mesh rounds: losses within 5e-6, params and velocities within
2e-7, masks equal (as the CPU parity tests).
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
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
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


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
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


# -- the serve slice: flash attention and the RG-LRU scan -----------------

SERVE_ARCH = "recurrentgemma-9b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
# RecurrentGemma-9B: 12 groups of (RGLRU, RGLRU, SWA) + 2 RGLRU layers
PREFILL_LAUNCHES = {"flash_attention": 12, "rglru_scan": 26}
# flash: (label, B, Sq, Sk, H, K, hd, dtype, causal, window, q_offset,
# kv_len); the first is the main path's shape (one SWA prefill layer)
FLASH_CASES = [
    ("main", 4, 4096, 4096, 16, 1, 256, "bfloat16", True, 2048, None, None),
    # ragged, suffix-aligned, kv_len < Sk: rows at q_pos >= 927 see no key
    ("ragged", 2, 300, 1000, 6, 2, 128, "bfloat16", True, 128, 700, 800),
    ("f32", 2, 777, 777, 4, 4, 64, "float32", True, 100, None, None),
]
SCAN_SHAPE = (4, 4096, 4096)        # (B, S, d_model) of the main prefill
F32_RTOL = 1e-5
SERVE_LOGIT_TOL = 5e-4


def bf16_ulp(x):
    """The spacing of bf16 at |x| (x given in f32)."""
    import torch
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def flash_out_check(label, got, want):
    """The forward kernel's output against the plain one: in bf16 within
    2 bf16 ulps of the plain output, the ulp taken at no less than 2^-16
    of the largest output (the f32 sums' own error scale); in f32 within
    F32_RTOL of the largest output. Returns (max abs err, max |out|,
    the rule)."""
    import torch
    diff = (got.float() - want.float()).abs()
    amax = float(want.float().abs().max())
    if got.dtype == torch.bfloat16:
        floor = torch.full_like(diff, 2.0 ** -16 * amax)
        tol = 2 * bf16_ulp(torch.maximum(want.float().abs(), floor))
        ok = bool((diff <= tol).all())
        rule = "2 bf16 ulps"
    else:
        ok = float(diff.max()) <= F32_RTOL * amax
        rule = f"{F32_RTOL:g} x max|out|"
    err = float(diff.max())
    check(ok, f"flash_attention {label}: max abs err {err} exceeds {rule}")
    return err, amax, rule


def flash_case_check(dev, case, g):
    """Kernel against plain on one case; returns (max_abs_err, inputs)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    (label, B, Sq, Sk, H, K, hd, dtype, causal, window, q_offset,
     kv_len) = case
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
    k = torch.randn((B, Sk, K, hd), generator=g, device=dev).to(dt)
    v = torch.randn((B, Sk, K, hd), generator=g, device=dev).to(dt)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    got = fops.flash_attention(q, k, v, **kw)
    want = fref.attention_ref(q, k, v, causal=causal, window=window,
                              q_offset=Sk - Sq if q_offset is None
                              else q_offset, kv_len=kv_len)
    torch.cuda.synchronize()
    err, amax, rule = flash_out_check(label, got, want)
    if kv_len is not None and window:
        pos = q_offset + torch.arange(Sq, device=dev)
        empty = pos - window >= kv_len - 1
        check(bool(empty.any()) and bool((got[:, empty] == 0).all()),
              f"flash_attention {label}: fully masked rows are not 0")
    print(f"[check] flash_attention {label} {dtype} B={B} Sq={Sq} Sk={Sk} "
          f"H={H} K={K} hd={hd} window={window}: max abs err {err:.3g} "
          f"(max |out| {amax:.3g}; within {rule})", flush=True)
    return err, (q, k, v, kw)


def serve_kernel_checks(dev):
    """Phase 7: the serve slice's two kernels against their plain
    versions on the card, at the main prefill's shapes and more; times,
    library times and bounds at the main shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rglru_scan import ops as sops
    from repro_torch.kernels.rglru_scan import ref as sref

    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    errs = [flash_case_check(dev, c, g) for c in FLASH_CASES]
    q, k, v, kw = errs[0][1]
    B, S, H, hd = q.shape
    K = k.shape[2]
    mask = fref.attention_mask(S, S, causal=True, window=kw["window"],
                               q_offset=0, kv_len=S, device=dev)
    pairs = int(mask.sum()) * B * H          # unmasked (query, key) pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bnd, by = bound_ms(nbytes, 4 * hd * pairs, BF16_OPS_PER_S)
    # the library yardstick: one SDPA call with the same boolean mask
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).expand(B, H, S, hd).contiguous()
    vt = v.transpose(1, 2).expand(B, H, S, hd).contiguous()
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    plain = fref.attention_ref(q, k, v, causal=True, window=kw["window"])
    sdpa_err = float((sdpa.transpose(1, 2).float() - plain.float()).abs()
                     .max())
    del sdpa, plain
    t = {"ms": graph_ms(lambda: fops.flash_attention(q, k, v, **kw), 10),
         "eager_ms": time_ms(lambda: fops.flash_attention(q, k, v, **kw), 10),
         "plain_ms": time_ms(lambda: fref.attention_ref(
             q, k, v, causal=True, window=kw["window"]), 3),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, attn_mask=mask), 10)}
    out["flash_attention"] = dict(t, max_abs_err=max(e for e, _ in errs),
                                  bound_ms=bnd, bound_by=by)
    print(f"[time] flash_attention main (B={B} S={S} H={H} K={K} hd={hd} "
          f"window={kw['window']} bf16): device {t['ms']:.4f} ms/launch, "
          f"eager call {t['eager_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
          f"library (SDPA, bool mask) {t['library_ms']:.4f} ms "
          f"(max |SDPA - plain| {sdpa_err:.3g}), bound {bnd:.4g} ms ({by}; "
          f"{pairs} pairs, {nbytes} B)", flush=True)
    del q, k, v, qt, kt, vt, mask, errs
    torch.cuda.empty_cache()

    # the scan, bitwise, at the main prefill's shape
    B, S, D = SCAN_SHAPE
    a = torch.rand((B, S, D), generator=g, device=dev) * 0.5 + 0.499
    b = 0.1 * torch.randn((B, S, D), generator=g, device=dev)
    h0 = torch.randn((B, D), generator=g, device=dev)
    states, final = sops.rglru_scan(h0, a, b)
    want = sref.rglru_scan_ref(h0, a, b)
    torch.cuda.synchronize()
    err = float((states - want).abs().max())
    check(torch.equal(states, want) and torch.equal(final, want[:, -1]),
          f"rglru_scan: not bitwise equal to the plain version (max abs "
          f"err {err})")
    print(f"[check] rglru_scan B={B} S={S} D={D} f32: bitwise equal to the "
          f"plain version", flush=True)
    nbytes = 12 * B * S * D + 8 * B * D
    bnd, by = bound_ms(nbytes, 2 * B * S * D)
    t = {"ms": graph_ms(lambda: sops.rglru_scan(h0, a, b), 10),
         "eager_ms": time_ms(lambda: sops.rglru_scan(h0, a, b), 10),
         "plain_ms": time_ms(lambda: sref.rglru_scan_ref(h0, a, b), 3),
         "library_ms": None}
    out["rglru_scan"] = dict(t, max_abs_err=err, bound_ms=bnd, bound_by=by)
    print(f"[time] rglru_scan main (B={B} S={S} D={D}): device "
          f"{t['ms']:.4f} ms/launch, eager call {t['eager_ms']:.4f} ms, "
          f"plain {t['plain_ms']:.3f} ms, library none, bound {bnd:.4g} ms "
          f"({by}, {nbytes} B)", flush=True)
    del a, b, h0, states, final, want
    torch.cuda.empty_cache()
    return out


def small_serve_check(dev):
    """Phase 8: reduced recurrentgemma-9b in f32, prompt past its window
    of 64, on the card (kernels) against the CPU (plain versions) from
    the same params carried over by the bridge."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(get_arch(SERVE_ARCH).reduced(),
                              dtype="float32")
    model = Transformer(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0), "cpu")
    gpu_params = bridge.transformer_params_from_numpy(
        cfg, bridge.tree_to_numpy(cpu_params), dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 96),
                           generator=torch.Generator().manual_seed(1))
    want = generate(model, cpu_params, tokens, 8)
    got = generate(model, gpu_params, tokens.to(dev), 8)
    err = float((got.logits.cpu() - want.logits).abs().max())
    check(err <= SERVE_LOGIT_TOL,
          f"small serve: card vs CPU logits max abs err {err}")
    check(torch.equal(got.tokens.cpu(), want.tokens),
          "small serve: greedy tokens differ between card and CPU")
    check(got.launches == {"prefill": {"flash_attention": 1,
                                       "rglru_scan": 2}, "decode": {}},
          f"small serve: launches {got.launches}")
    print(f"[small] serve {cfg.name} f32 B=2 prompt 96 gen 8, card vs CPU: "
          f"logits max abs err {err:.3g} (tol {SERVE_LOGIT_TOL:g}), greedy "
          f"tokens equal, launches {got.launches}", flush=True)


def serve_main_path():
    """Phase 9: the serve path at full width through the user's entry
    point, counts reset just before and read just after."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import serve

    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    t0 = time.perf_counter()
    rec = serve(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                gen_len=SERVE_GEN, reduced=False)
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] {SERVE_ARCH} full width B={SERVE_BATCH} prompt "
          f"{SERVE_PROMPT} gen {SERVE_GEN}: prefill {rec['prefill_s']:.4f} s "
          f"({rec['prefill_tok_per_s']:.1f} tok/s), decode "
          f"{rec['decode_s']:.4f} s for {SERVE_GEN - 1} steps "
          f"({rec['decode_tok_per_s']:.2f} tok/s), peak memory "
          f"{peak / 2**30:.2f} GiB; {wall:.1f} s with init and warm-up; "
          f"timed-pass launches {rec['launches']}, all launches {counts}; "
          f"sample {rec['output_sample']}", flush=True)
    check(rec["output_shape"] == [SERVE_BATCH, SERVE_GEN],
          f"serve output shape {rec['output_shape']}")
    check(rec["logits_finite"], "serve logits not finite")
    check(rec["launches"]["prefill"] == PREFILL_LAUNCHES,
          f"one prefill launched {rec['launches']['prefill']}, expected "
          f"{PREFILL_LAUNCHES}")
    check(rec["launches"]["decode"] == {},
          f"decode launched {rec['launches']['decode']}, expected none")
    # the warm-up pass (prefill + one decode step) and the timed pass
    want = {k: 2 * n for k, n in PREFILL_LAUNCHES.items()}
    check(counts == want, f"serve launched {counts}, expected {want}")
    return counts


def profile_serve(dev) -> None:
    """One more full-width prefill and one decode step under
    torch.profiler, after the counted run: device time by kernel, split
    into GEMMs, the two hand-written kernels and the rest, and each
    one's device busy share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Transformer

    model = Transformer(get_arch(SERVE_ARCH))
    gen = torch.Generator(device=dev).manual_seed(2)
    params = model.init(gen, dev)
    tokens = torch.randint(0, model.cfg.vocab_size,
                           (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                           device=dev)

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return out, prof, wall_ms

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    def device_rows(prof):
        return sorted((e for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA")
                       and dev_us(e) > 0), key=dev_us, reverse=True)

    def ms_of(rows, *words):
        return sum(dev_us(e) for e in rows
                   if any(w in e.key.lower() for w in words)) / 1e3

    gemm_words = ("gemm", "gemv", "xmma", "cutlass", "sm90_", "nvjet")
    with torch.no_grad():
        cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, dev)
        (logits, cache), prof, wall_ms = profiled(
            lambda: model.prefill(params, {"tokens": tokens}, cache))
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        model.decode_step(params, tok, cache)       # warm, then one step
        _, dprof, dwall_ms = profiled(
            lambda: model.decode_step(params, tok, cache))

    rows = device_rows(prof)
    total = sum(dev_us(e) for e in rows) / 1e3
    flash = ms_of(rows, "flash_attention_kernel")
    scan = ms_of(rows, "rglru_scan_kernel")
    gemm = ms_of(rows, *gemm_words)
    print(f"[profile] one full-width prefill (B={SERVE_BATCH} S="
          f"{SERVE_PROMPT}): wall {wall_ms:.1f} ms (profiler on), device "
          f"busy {total:.1f} ms ({100 * total / wall_ms:.1f}%): GEMMs "
          f"{gemm:.1f} ms, flash_attention {flash:.1f} ms, rglru_scan "
          f"{scan:.1f} ms, other {total - gemm - flash - scan:.1f} ms; "
          f"{sum(e.count for e in rows)} device ops", flush=True)
    for e in rows[:14]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    rows = device_rows(dprof)
    total = sum(dev_us(e) for e in rows) / 1e3
    aten = sum(e.count for e in dprof.key_averages()
               if e.key.startswith("aten::"))
    print(f"[profile] one decode step (B={SERVE_BATCH}): wall "
          f"{dwall_ms:.1f} ms (profiler on), device busy {total:.2f} ms "
          f"({100 * total / dwall_ms:.1f}%), GEMMs "
          f"{ms_of(rows, *gemm_words):.2f} ms; {sum(e.count for e in rows)} "
          f"device ops, {aten} aten calls (nested included)", flush=True)
    for e in rows[:6]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    del params, cache
    torch.cuda.empty_cache()


# -- the mesh slice: the fused PSO update and the flash backward ----------

MESH_ARCH, MESH_W, MESH_B, MESH_S = "smollm-360m", 2, 2, 2048
MESH_SPEC = ("model.reduced=false", f"model.seq_len={MESH_S}",
             f"run.rounds={ROUNDS}")
# pso_update: (label, leaf shape); the first is the largest SmolLM-360M
# leaf (groups/b0/mlp/wi: 32 layers x 960 x 2560), stacked over W
PSO_CASES = [("main", (32, 960, 2560)), ("ragged", (1001,))]
# flash backward: as FLASH_CASES; the first is the SmolLM train shape
FLASH_BWD_CASES = [
    ("main", 2, 2048, 2048, 15, 5, 64, "bfloat16", True, 0, None, None),
    ("f32", 2, 2048, 2048, 15, 5, 64, "float32", True, 0, None, None),
    # windowed, ragged, suffix-aligned GQA; rows at q_pos >= 927 see no key
    ("ragged", 2, 300, 1000, 6, 2, 128, "bfloat16", True, 128, 700, 800),
]
BWD_F32_RTOL = 1e-5
LSE_ATOL = 1e-5          # the forward's log-sum-exp, f32, |lse| < ~20 here
MESH_LOSS_TOL, MESH_PARAM_TOL = 5e-6, 2e-7


def pso_checks(dev):
    """pso_update against its plain version, bitwise, and its times at
    the main leaf in bf16 (the main path's dtype)."""
    import torch
    from repro_torch.kernels.pso_update import ops as pops
    from repro_torch.kernels.pso_update import ref as pref

    g = torch.Generator(device=dev).manual_seed(3)
    W = MESH_W
    out = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for label, leaf in PSO_CASES:
            def draw(scale, shape):
                return (scale * torch.randn(shape, generator=g, device=dev)
                        ).to(dtype)
            w, wl = draw(0.1, (W,) + leaf), draw(0.1, (W,) + leaf)
            v, d = draw(0.01, (W,) + leaf), draw(1e-3, (W,) + leaf)
            wg = draw(0.1, leaf)
            for clip in (0.0, 0.02):
                co = torch.cat([torch.rand((W, 1), generator=g, device=dev),
                                torch.randn((W, 2), generator=g, device=dev),
                                torch.full((W, 1), clip, device=dev)],
                               1).contiguous()
                kw_, kv_ = pops.pso_update(co, w, v, wl, wg, d)
                pw_, pv_ = pref.pso_update_ref(co, w, v, wl, wg, d)
                torch.cuda.synchronize()
                e = float((kw_.float() - pw_.float()).abs().max())
                out["max_abs_err"] = max(out["max_abs_err"], e, float(
                    (kv_.float() - pv_.float()).abs().max()))
                check(torch.equal(kw_, pw_) and torch.equal(kv_, pv_),
                      f"pso_update {dtype} {label} clip={clip}: not bitwise "
                      f"equal to the plain version (max abs err {e})")
            print(f"[check] pso_update {str(dtype)[6:]} {label} W={W} "
                  f"leaf={leaf}, clip off and on: bitwise equal to the "
                  f"plain version", flush=True)
            if label == "main" and dtype == torch.bfloat16:
                n = wg.numel()
                nbytes = w.element_size() * (6 * W * n + n) + 16 * W
                bnd, by = bound_ms(nbytes, 8 * W * n)
                t = {"ms": graph_ms(lambda: pops.pso_update(
                         co, w, v, wl, wg, d), 10),
                     "eager_ms": time_ms(lambda: pops.pso_update(
                         co, w, v, wl, wg, d), 10),
                     "plain_ms": time_ms(lambda: pref.pso_update_ref(
                         co, w, v, wl, wg, d), 3),
                     "library_ms": None}
                out.update(t, bound_ms=bnd, bound_by=by)
                print(f"[time] pso_update main (W={W}, leaf {leaf}, bf16): "
                      f"device {t['ms']:.4f} ms/launch, eager call "
                      f"{t['eager_ms']:.4f} ms, plain {t['plain_ms']:.3f} "
                      f"ms, library none, bound {bnd:.4g} ms ({by}, "
                      f"{nbytes} B)", flush=True)
            del w, wl, v, d, wg
    torch.cuda.empty_cache()
    return out


def flash_bwd_case(dev, case, g):
    """The backward kernel against `attention_bwd_ref` and autograd of
    `attention_ref` on one case; returns (max_abs_err vs the plain
    backward, the inputs)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    (label, B, Sq, Sk, H, K, hd, dtype, causal, window, q_offset,
     kv_len) = case
    dt = getattr(torch, dtype)
    q, do = (torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, K, hd), generator=g, device=dev).to(dt)
            for _ in range(2))
    kw = dict(causal=causal, window=window,
              q_offset=Sk - Sq if q_offset is None else q_offset,
              kv_len=kv_len)
    # the training forward (the one that writes the log-sum-exp) against
    # the plain forward at this shape: out, and lse (-inf on rows with
    # no valid key, in the same rows)
    out, lse = fops._forward(q, k, v, causal, window, q_offset, kv_len, True)
    want, want_lse = fref.attention_ref(q, k, v, **kw, return_lse=True)
    torch.cuda.synchronize()
    err, amax, rule = flash_out_check(f"{label} (training forward)", out,
                                      want)
    fin = torch.isfinite(want_lse)
    check(torch.equal(torch.isfinite(lse), fin)
          and bool((lse[~fin] == want_lse[~fin]).all()),
          f"flash forward {label}: lse not -inf exactly where the plain "
          f"one is")
    lerr = float((lse[fin] - want_lse[fin]).abs().max())
    check(lerr <= LSE_ATOL, f"flash forward {label}: lse max abs err {lerr} "
                            f"exceeds {LSE_ATOL:g}")
    print(f"[check] flash forward (with lse) {label} {dtype} B={B} Sq={Sq} "
          f"Sk={Sk} H={H} K={K} hd={hd} window={window}: out max abs err "
          f"{err:.3g} (max |out| {amax:.3g}; within {rule}), lse max abs "
          f"err {lerr:.3g} (within {LSE_ATOL:g}; {int((~fin).sum())} rows "
          f"-inf in both)", flush=True)
    del want, want_lse
    got = fops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    plain = fref.attention_bwd_ref(q, k, v, out, do, lse, **kw)
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(fref.attention_ref(*xs, **kw), xs, do)
    torch.cuda.synchronize()
    errs = []
    for name, refs in (("plain", plain), ("autograd", auto)):
        for n, a, b in zip("qkv", got, refs):
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"flash backward {label} "
                                                 f"d{n} not finite")
            diff, amax = (a - b).abs(), float(b.abs().max())
            if dt == torch.float32:
                ok, rule = (float(diff.max()) <= BWD_F32_RTOL * amax,
                            f"{BWD_F32_RTOL:g} x max|grad|")
            elif name == "plain":
                floor = torch.full_like(b, 2.0 ** -12 * amax)
                ok = bool((diff <= 2 * bf16_ulp(torch.maximum(b.abs(),
                                                              floor))).all())
                rule = "2 bf16 ulps"
            else:
                ok = float(diff.max()) <= 4 * float(bf16_ulp(
                    torch.tensor(amax)))
                rule = "4 bf16 ulps of max|grad|"
            check(ok, f"flash backward {label} d{n} vs {name}: max abs err "
                      f"{float(diff.max())} exceeds {rule}")
            if name == "plain":
                errs.append(float(diff.max()))
            print(f"[check] flash backward {label} {dtype} d{n} vs {name}: "
                  f"max abs err {float(diff.max()):.3g} (max |grad| "
                  f"{amax:.3g}; within {rule})", flush=True)
    if kv_len is not None and window:
        pos = kw["q_offset"] + torch.arange(Sq, device=dev)
        empty = pos - window >= kv_len - 1
        check(bool(empty.any()) and bool((got[0][:, empty] == 0).all()),
              f"flash backward {label}: fully masked rows get a gradient")
    del plain, auto, xs
    return max(errs), (q, k, v, out, do, lse, kw)


def flash_bwd_checks(dev):
    """The backward kernel on every case; times and bounds at the main
    (SmolLM train) shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    g = torch.Generator(device=dev).manual_seed(4)
    results = [flash_bwd_case(dev, c, g) for c in FLASH_BWD_CASES]
    for hd in (64, 128, 256):
        try:
            fops.require_bwd_head_dim(hd)
            ok = hd != 256
        except ValueError:
            ok = hd == 256
        check(ok, f"flash backward library: head_dim {hd} "
                  f"{'accepted' if hd == 256 else 'refused'}")
    print("[check] flash backward library: head dims 64 and 128 accepted, "
          "256 refused", flush=True)
    err = max(e for e, _ in results)
    q, k, v, out, do, lse, kw = results[0][1]
    B, S, H, hd = q.shape
    K = k.shape[2]
    pairs = B * H * S * (S + 1) // 2          # unmasked (query, key) pairs
    nbytes = 2 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + do.numel()) + 4 * lse.numel()
    bnd, by = bound_ms(nbytes, 10 * hd * pairs, BF16_OPS_PER_S)

    def bwd():
        return fops.flash_attention_bwd(q, k, v, out, do, lse, **kw)

    def fwd_bwd():
        o, lz = fops._forward(q, k, v, True, 0, None, None, True)
        return fops.flash_attention_bwd(q, k, v, o, do, lz, **kw)

    # the library yardstick: SDPA forward + backward, causal, with the
    # kv heads repeated (timed here, used nowhere in the port)
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.transpose(1, 2).repeat_interleave(H // K, 1).contiguous() \
        .requires_grad_()
    vt = v.transpose(1, 2).repeat_interleave(H // K, 1).contiguous() \
        .requires_grad_()
    dot = do.transpose(1, 2)

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    t = {"ms": graph_ms(bwd, 5), "eager_ms": time_ms(bwd, 10),
         "plain_ms": time_ms(lambda: fref.attention_bwd_ref(
             q, k, v, out, do, lse, **kw), 3),
         "library_ms": time_ms(sdpa, 10)}
    fb = time_ms(fwd_bwd, 10)
    print(f"[time] flash backward main (B={B} S={S} H={H} K={K} hd={hd} "
          f"causal bf16): device {t['ms']:.4f} ms/launch, eager call "
          f"{t['eager_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms; kernel "
          f"forward (with lse) + backward {fb:.4f} ms against library "
          f"(SDPA forward + backward, causal) {t['library_ms']:.4f} ms; "
          f"bound {bnd:.4g} ms ({by}; {pairs} pairs at 10 hd operations, "
          f"{nbytes} B)", flush=True)
    del results, q, k, v, out, do, lse, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(t, max_abs_err=err, bound_ms=bnd, bound_by=by,
                fwd_bwd_ms=fb)


def small_mesh_check(dev):
    """Two M-DSL rounds of reduced smollm-360m in f32 (W = 2) on the card
    (kernels) against the same rounds on the CPU (plain versions), from
    the same params (through the bridge), batches and draws."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.core import swarm_dist
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import Transformer
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_arch(MESH_ARCH).reduced(), dtype="float32")
    model = Transformer(cfg)
    gen = torch.Generator().manual_seed(5)
    cpu_params = model.init(gen, "cpu")
    gpu_params = bridge.transformer_params_from_numpy(
        cfg, bridge.tree_to_numpy(cpu_params), dev)
    dcfg = swarm_dist.DistSwarmConfig(num_spatial=MESH_W)
    step = swarm_dist.build_train_step(model.loss, dcfg)
    cs = swarm_dist.init_state(cpu_params, dcfg)
    gs = swarm_dist.init_state(gpu_params, dcfg)

    def to_dev(x):
        return None if x is None else tree_map(lambda t: t.to(dev), x)

    runtime.reset_counts()
    for r in range(2):
        toks = torch.randint(0, cfg.vocab_size, (MESH_W + 1, 2, 128),
                             generator=gen)
        batch = {"tokens": toks[:MESH_W],
                 "labels": torch.roll(toks[:MESH_W], -1, dims=-1)}
        ev = {"tokens": toks[MESH_W], "labels": torch.roll(toks[MESH_W], -1,
                                                           dims=-1)}
        draws = swarm_dist.sample_draws(gen, dcfg, cpu_params, "cpu")
        cs, ci = step(cs, batch, ev, draws)
        gs, gi = step(gs, to_dev(batch), to_dev(ev),
                      type(draws)(*[to_dev(x) for x in draws]))
        torch.cuda.synchronize()
        check(torch.equal(ci.mask, gi.mask.cpu()), f"small mesh round "
                                                   f"{r + 1}: masks")
        lerr = max(float((gi.losses.cpu() - ci.losses).abs().max()),
                   abs(float(gi.global_loss) - float(ci.global_loss)))
        perr = max(float((a.cpu() - b).abs().max())
                   for f in ("params", "velocity", "global_params")
                   for a, b in zip(tree_leaves(getattr(gs, f)),
                                   tree_leaves(getattr(cs, f))))
        check(lerr <= MESH_LOSS_TOL and perr <= MESH_PARAM_TOL,
              f"small mesh round {r + 1}: card vs CPU losses off by {lerr}, "
              f"params/velocity off by {perr}")
        print(f"[small] mesh round {r + 1} {cfg.name} f32 W={MESH_W} card "
              f"vs CPU: masks equal, losses max abs err {lerr:.3g} (tol "
              f"{MESH_LOSS_TOL:g}), params and velocity {perr:.3g} (tol "
              f"{MESH_PARAM_TOL:g})", flush=True)
    counts = runtime.counts()
    want = {k: 2 * n for k, n in mesh_launches_per_round(
        cfg, len(tree_leaves(cpu_params))).items()}
    check(counts == want, f"small mesh rounds launched {counts}, expected "
                          f"{want}")


def mesh_launches_per_round(cfg, n_leaves: int) -> dict:
    """Kernel launches of one M-DSL round: per layer, each worker's
    forward and remat recompute plus W + 1 evaluations through the
    forward kernel, each worker's backward, and Eq. 8 once per leaf."""
    L, W = cfg.num_layers, MESH_W
    return {"flash_attention": L * (2 * W + W + 1),
            "flash_attention_bwd": L * W, "pso_update": n_leaves}


def mesh_main_path():
    """The mesh training path at full width through the user's entry
    point, counts reset just before and read just after."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.experiments import get_scenario, override, run
    from repro_torch.kernels import runtime
    from repro_torch.pytree import tree_leaves

    spec = override(get_scenario("mesh/smollm-smoke"), *MESH_SPEC)
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    t0 = time.perf_counter()
    result = run(spec)
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rec = result.record
    gp = result.state.global_params
    n_params = sum(x.numel() for x in tree_leaves(gp))
    tokens = MESH_W * MESH_B * MESH_S
    for t in range(ROUNDS):
        print(f"[mesh] round {t + 1}{' (warm-up)' if t == 0 else ''}: "
              f"{rec['step_time_s'][t]:.4f} s, global loss "
              f"{rec['global_loss'][t]:.5f}, worker losses "
              f"{rec['worker_losses'][t]}, selected {rec['selected'][t]}/"
              f"{MESH_W}, launches {rec['launches'][t]}", flush=True)
    steady = rec["step_time_s"][1:]
    print(f"[mesh] {MESH_ARCH} full width ({n_params} params, bf16) W="
          f"{MESH_W} B={MESH_B} S={MESH_S} ({tokens} tokens a round): "
          f"{statistics.mean(steady):.4f} s per round after the warm-up "
          f"({tokens / statistics.mean(steady):.1f} tok/s), peak memory "
          f"{peak / 2**30:.2f} GiB; {wall:.1f} s with init; all launches "
          f"{counts}", flush=True)
    check(rec["device"] == torch.cuda.get_device_name(0),
          f"mesh run on {rec['device']}")
    check(all(math.isfinite(v) for v in rec["global_loss"]),
          "mesh global loss not finite")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(gp)),
          "mesh global params not finite")
    per_round = mesh_launches_per_round(get_arch(MESH_ARCH),
                                        len(tree_leaves(gp)))
    for t in range(ROUNDS):
        check(rec["launches"][t] == per_round,
              f"mesh round {t + 1} launched {rec['launches'][t]}, expected "
              f"{per_round}")
    want = {k: ROUNDS * n for k, n in per_round.items()}
    check(counts == want, f"mesh run launched {counts}, expected {want}")
    return counts, spec


def profile_mesh(spec) -> None:
    """One more full-width round under torch.profiler, after the counted
    run: the device's busy share, device time split into GEMMs, the flash
    forward and backward, pso_update and the rest, the top device ops and
    the stage ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.experiments import build

    prep = build(spec)
    state, _ = prep.step(prep.state, prep.draw(prep.state))     # warm
    draws = prep.draw(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prep.step(state, draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    names = ("LocalUpdate", "ScoreSelect", "Uplink", "Aggregate",
             "Downlink", "BestTracking")
    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
                   and e.key not in names), key=dev_us, reverse=True)

    def ms_of(*words):
        return sum(dev_us(e) for e in rows
                   if any(w in e.key.lower() for w in words)) / 1e3

    busy = sum(dev_us(e) for e in rows) / 1e3
    gemm = ms_of("gemm", "gemv", "xmma", "cutlass", "sm90_", "nvjet")
    fwd = ms_of("flash_attention_kernel")
    bwd = ms_of("dkdv_kernel", "dq_kernel", "dot_kernel")
    pso = ms_of("pso_update_kernel")
    print(f"[profile] one full-width mesh round: wall {wall_ms:.1f} ms "
          f"(profiler on), device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%): GEMMs {gemm:.1f} ms, flash "
          f"forward {fwd:.1f} ms, flash backward {bwd:.1f} ms, pso_update "
          f"{pso:.2f} ms, other {busy - gemm - fwd - bwd - pso:.1f} ms; "
          f"{sum(e.count for e in rows)} device ops", flush=True)
    stages = {e.key: e for e in prof.key_averages()
              if e.key in names and str(e.device_type).endswith("CPU")}
    print("[profile] stages (host ms / device ms of its kernels): " + ", ".join(
        f"{k} {stages[k].cpu_time_total / 1e3:.2f}/"
        f"{getattr(stages[k], 'device_time_total', 0.0) / 1e3:.2f}"
        for k in names if k in stages), flush=True)
    for e in rows[:14]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    del prep, state, draws
    torch.cuda.empty_cache()


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

    serve_stats = serve_kernel_checks(dev)
    small_serve_check(dev)
    serve_counts = serve_main_path()
    profile_serve(dev)

    mesh_stats = {"pso_update": pso_checks(dev),
                  "flash_attention_bwd": flash_bwd_checks(dev)}
    small_mesh_check(dev)
    mesh_counts, mesh_spec = mesh_main_path()
    profile_mesh(mesh_spec)

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
    replaces = {
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:97",
        "rglru_scan": "src/repro/kernels/rglru_scan/rglru_scan.py:48"}
    kernels += [{"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{name}.cu",
                 "replaces": replaces[name],
                 "launches": serve_counts[name],
                 "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                 "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                 "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                 "eager_ms": s["eager_ms"], "check": "pass"}
                for name, s in serve_stats.items()]
    # flash_attention also runs on the mesh path: its launches there
    next(k for k in kernels if k["name"] == "flash_attention")[
        "launches_mesh"] = mesh_counts["flash_attention"]
    replaces = {
        "pso_update": "src/repro/kernels/pso_update/pso_update.py:42",
        # no TPU kernel: XLA's autodiff of chunked_attention
        "flash_attention_bwd": "src/repro/models/layers.py:129 (XLA autodiff "
                               "of chunked_attention; no TPU kernel)"}
    kernels += [{"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{name}.cu",
                 "replaces": replaces[name],
                 "launches": mesh_counts[name],
                 "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                 "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                 "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                 "eager_ms": s["eager_ms"], "check": "pass"}
                for name, s in mesh_stats.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
