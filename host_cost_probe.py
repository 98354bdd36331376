"""Host cost a call of each kernel wrapper, in two checkouts in turns.

    python3 host_cost_probe.py BASE_ROOT [THIS_ROOT]   # on the card

Each kernel wrapper (the ten launches of `repro_torch.kernels`) is called
in a tight loop on small CUDA tensors, where the host's work, not the
kernel, sets the pace: the best of 6 batches of 2000 calls, in µs a
call. Each checkout runs in a process of its own (each imports its own
`repro_torch` from its `src/`), in the order BASE, THIS, THIS, BASE,
BASE, THIS, and the script prints each run and, per wrapper, THIS's
median minus BASE's. It answers how much a change adds to a wrapper's
eager call (chip_smoke.py's `eager_ms` column reads one call between
CUDA events, whose run-to-run spread is tens of µs).
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ORDER = ("base", "this", "this", "base", "base", "this")


def measure(root: str) -> dict:
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops as f
    from repro_torch.kernels.pso_update import ops as p
    from repro_torch.kernels.quant_pack import ops as q
    from repro_torch.kernels.rglru_scan import ops as s
    from repro_torch.kernels.wire_agg import ops as w
    runtime.build_all()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    x, seeds = rand(2, 256, 128), torch.arange(2, dtype=torch.int32,
                                               device=dev)
    p8, s8 = q.quant_pack_2d(x, seeds, bits=8)
    mask = torch.ones(2, device=dev)
    bf = torch.bfloat16
    qq, kk = rand(1, 64, 2, 64, dtype=bf), rand(1, 64, 1, 64, dtype=bf)
    out, lse = f._forward(qq, kk, kk, True, 0, None, None, True)
    a, h = torch.rand((1, 32, 128), generator=g, device=dev), rand(1, 128)
    wp, co = rand(2, 8, 128, dtype=bf), torch.rand((2, 4), device=dev)
    calls = {
        "quant_pack": lambda: q.quant_pack_2d(x, seeds, bits=8),
        "quant_pack_ef": lambda: q.quant_pack_ef_2d(x, x, seeds, bits=8),
        "dequant_unpack": lambda: q.dequant_unpack_2d(p8, s8, bits=8),
        "wire_agg": lambda: w.wire_agg_2d(p8, s8, mask, mask, bits=8),
        "flash_attention": lambda: f.flash_attention(qq, kk, kk),
        "flash_attention (with lse)": lambda: f._forward(
            qq, kk, kk, True, 0, None, None, True),
        "flash_attention_bwd": lambda: f.flash_attention_bwd(
            qq, kk, kk, out, out, lse),
        "rglru_scan": lambda: s.rglru_scan_raw(h, a, a),
        "rglru_scan_bwd": lambda: s.rglru_scan_bwd_raw(h, a, a, a),
        "pso_update": lambda: p.pso_update(co, wp, wp, wp, wp[0], wp),
    }
    res = {}
    for name, fn in calls.items():
        best = float("inf")
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            best = min(best, (time.perf_counter() - t0) / 2000 * 1e6)
        torch.cuda.synchronize()
        res[name] = best
    return res


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    import torch
    if not torch.cuda.is_available():
        sys.exit("host_cost_probe: needs a CUDA card")
    roots = {"base": sys.argv[1],
             "this": sys.argv[2] if len(sys.argv) > 2
             else str(Path(__file__).resolve().parent)}
    runs = {"base": [], "this": []}
    for side in ORDER:
        out = subprocess.run([sys.executable, __file__, "--one", roots[side]],
                             check=True, capture_output=True, text=True)
        got = json.loads(out.stdout.strip().splitlines()[-1])
        runs[side].append(got)
        print(side, roots[side], {k: round(v, 2) for k, v in got.items()},
              flush=True)
    for name in runs["base"][0]:
        b = statistics.median(r[name] for r in runs["base"])
        t = statistics.median(r[name] for r in runs["this"])
        spread = max(r[name] for r in runs["base"]) - min(
            r[name] for r in runs["base"])
        print(f"{name:28s} base {b:7.2f} µs, this {t:7.2f} µs, "
              f"this - base {t - b:+6.2f} µs (base's own spread "
              f"{spread:.2f})", flush=True)


if __name__ == "__main__":
    main()
