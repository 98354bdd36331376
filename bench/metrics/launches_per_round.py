"""Device operations (kernels, copies, fills) a round launched inside a
program span. Those launched outside every one (the benchmark's own
draws and loss read) go to standard error, with their device ms."""
import sys

from bench.metrics import _spans


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    n_in, n_out, out_ms = _spans.launches(tr)
    print(f"[bench] launches a round outside the program's spans: "
          f"{n_out:.1f}, {out_ms:.4f} device ms", file=sys.stderr)
    return n_in if n_in else None
