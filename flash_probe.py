#!/usr/bin/env python3
"""Quick card check of the flash kernels' tensor-core builds, for work on
src/repro_torch/csrc/flash_*.

    python3 flash_probe.py     # one CUDA card and nvcc; about a minute
    python3 flash_probe.py "hd80 StableLM-3B"   # the named cases alone

Builds the two flash libraries with ptxas's report (registers and spills
of each tensor-core kernel), holds the bf16 forward and backward against
the plain versions at ragged and model shapes under chip_smoke.py's
2-ulp rules (a NaN counts as a miss), and times from CUDA graphs the
hd-80 forward at StableLM-3B's serve shape beside SDPA, the forward and
backward at SmolLM-360M's training shape, the hd-80 backward at
StableLM-3B's training shape beside SDPA's backward alone and its
bound, and the hd-256 backward at RecurrentGemma-9B's shape beside the
CUDA-core kernels; the hd-80 backward's device time is also split by
kernel (prep, dK/dV, dQ) under torch.profiler. With case labels as
arguments it runs those cases alone, without ptxas's report. Exits
non-zero on a miss. chip_smoke.py stays the check of record.
"""
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (label, B, Sq, Sk, H, K, hd, causal, window, q_offset, kv_len)
FWD = [("hd80 ragged", 2, 300, 1000, 6, 2, 80, True, 128, 700, 800),
       ("hd72", 1, 500, 500, 4, 4, 72, True, 0, None, None),
       ("hd80 window", 1, 333, 333, 2, 1, 80, False, 50, None, None),
       ("hd64", 2, 1024, 1024, 8, 2, 64, True, 0, None, None),
       ("hd128 ragged", 2, 300, 1000, 6, 2, 128, True, 128, 700, 800),
       ("hd256", 1, 1024, 1024, 4, 1, 256, True, 512, None, None),
       ("hd80 serve", 4, 4096, 4096, 32, 32, 80, True, 0, None, None)]
BWD = [("hd256 ragged", 2, 300, 1000, 4, 2, 256, True, 128, 700, 800),
       ("hd256", 1, 512, 512, 4, 1, 256, True, 0, None, None),
       ("hd200", 1, 300, 300, 2, 1, 200, True, 0, None, None),
       ("hd64 mesh", 2, 2048, 2048, 15, 5, 64, True, 0, None, None),
       ("hd128 ragged", 2, 300, 1000, 6, 2, 128, True, 128, 700, 800),
       ("hd80", 1, 1024, 1024, 8, 8, 80, True, 0, None, None),
       ("hd80 ragged", 2, 300, 1000, 6, 2, 80, True, 128, 700, 800),
       ("hd72 ragged", 1, 333, 333, 4, 2, 72, True, 100, None, None),
       ("hd80 StableLM-3B", 2, 2048, 2048, 32, 32, 80, True, 0, None, None),
       ("hd256 RecurrentGemma-9B", 2, 2048, 2048, 16, 1, 256, True, 2048,
        None, None)]


def ptxas_report() -> None:
    """Compile both flash sources with -Xptxas -v into the runtime's
    cache and print each tensor-core kernel's registers and spills."""
    from repro_torch.kernels import runtime
    runtime.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(runtime._target(name)), str(runtime.CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(log[-6000:])
            sys.exit(f"flash_probe: nvcc failed for {name}")
        for line in ptxas_lines(log):
            print(f"[ptxas] {name}: {line}", flush=True)


def ptxas_lines(log: str) -> list[str]:
    """`kernel<HD>: registers, spill stores, spill loads` for each
    tensor-core kernel in nvcc's -Xptxas -v log, and every warning."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            m = re.search(r"([a-z]+_tc_kernel)ILi(\d+)E", ln)
            name = f"{m[1]}<{m[2]}>" if m else None
            stats = {}
        elif "warning" in ln.lower():
            out.append(ln.strip())
        elif name is not None:
            for key, pat in (("spill stores", r"(\d+) bytes spill stores"),
                             ("spill loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers")):
                m = re.search(pat, ln)
                if m:
                    stats[key] = int(m[1])
            if "registers" in stats:
                out.append(f"{name}: {stats['registers']} registers, "
                           f"{stats.get('spill stores', '?')} B spill "
                           f"stores, {stats.get('spill loads', '?')} B "
                           f"spill loads")
                name = None
    return out


def kernel_split(fn, reps: int) -> dict[str, float]:
    """Device µs a call of `fn` by kernel (the name up to its template
    arguments), from torch.profiler over `reps` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)
        if us > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::|[<(].*$", "",
                          e.key)
            split[name] = round(split.get(name, 0.0) + us / reps, 2)
    return split


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_probe: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops, ref

    only = set(sys.argv[1:])
    t0 = time.perf_counter()
    if not only:
        ptxas_report()
    print(f"[build] {time.perf_counter() - t0:.1f} s; "
          f"{cs.card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    bad = []

    def misses(got, want, floor_exp):
        want = want.float()
        floor = torch.full_like(want,
                                2.0 ** floor_exp * float(want.abs().max()))
        tol = 2 * cs.bf16_ulp(torch.maximum(want.abs(), floor))
        d = (got.float() - want).abs()
        return int((~(d <= tol)).sum()), float(d.max())

    def inputs(B, Sq, Sk, H, K, hd):
        q, do = (torch.randn((B, Sq, H, hd), generator=g, device=dev)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn((B, Sk, K, hd), generator=g, device=dev)
                .bfloat16() for _ in range(2))
        return q, k, v, do

    for label, B, Sq, Sk, H, K, hd, causal, window, qo, kl in FWD:
        if only and label not in only:
            continue
        q, k, v, _ = inputs(B, Sq, Sk, H, K, hd)
        kw = dict(causal=causal, window=window, q_offset=qo, kv_len=kl)
        runtime.reset_counts()
        got = ops.flash_attention(q, k, v, **kw)
        counts = runtime.counts()
        want = ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=Sk - Sq if qo is None else qo,
                                 kv_len=kl)
        torch.cuda.synchronize()
        n, e = misses(got, want, -16)
        print(f"[fwd] {label}: {counts}, build "
              f"{ops._lib().fa_tc_build_head_dim(hd)}, misses {n}, max abs "
              f"err {e:.3g}", flush=True)
        if n:
            bad.append(f"forward {label}")
        if label == "hd80 serve":
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms = cs.graph_ms(lambda: ops.flash_attention(q, k, v, **kw), 5)
            sdpa = cs.graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), 5)
            print(f"[time] hd80 forward, serve shape: {ms:.4f} ms, SDPA "
                  f"{sdpa:.4f} ms", flush=True)
        del q, k, v, got, want

    for label, B, Sq, Sk, H, K, hd, causal, window, qo, kl in BWD:
        if only and label not in only:
            continue
        q, k, v, do = inputs(B, Sq, Sk, H, K, hd)
        qo = Sk - Sq if qo is None else qo
        kw = dict(causal=causal, window=window, q_offset=qo, kv_len=kl)
        out, lse = ops._forward(q, k, v, causal, window, qo, kl, True)
        runtime.reset_counts()
        got = ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        counts = runtime.counts()
        want = ref.attention_bwd_ref(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        res = [misses(a, b, -12) for a, b in zip(got, want)]
        print(f"[bwd] {label}: {counts}, build "
              f"{ops._bwd_lib().fa_bwd_tc_build_head_dim(hd)}, (misses, max "
              f"abs err) of dq, dk, dv {res}", flush=True)
        if any(r[0] for r in res):
            bad.append(f"backward {label}")

        def bwd():
            return ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        if label == "hd64 mesh":
            fwd = cs.graph_ms(lambda: ops._forward(q, k, v, True, 0, None,
                                                   None, True), 10)
            print(f"[time] mesh shape: forward (with lse) {fwd:.4f} ms, "
                  f"backward {cs.graph_ms(bwd, 5):.4f} ms", flush=True)
        if label == "hd80 StableLM-3B":
            cs.time_flash_bwd(label, q, k, v, out, do, lse, kw)
            print(f"[profile] {label} backward, µs a launch by kernel: "
                  f"{kernel_split(bwd, 5)}", flush=True)
        if label.startswith("hd256 RecurrentGemma"):
            cc = cs.graph_ms(lambda: cs.cuda_core_backward(
                q, k, v, out, do, lse, causal, window, qo), 2)
            print(f"[time] hd256 backward, RecurrentGemma-9B shape: "
                  f"{cs.graph_ms(bwd, 3):.4f} ms, the CUDA-core kernels "
                  f"{cc:.4f} ms", flush=True)
        del q, k, v, do, out, lse, got, want
    if bad:
        sys.exit(f"flash_probe: misses in {bad}")
    print("[ok] every case within its rule", flush=True)


if __name__ == "__main__":
    main()
