"""Host milliseconds a round spent blocked on the device inside the
program's spans: the device-to-host reads and the copies through
pageable host memory (`_spans.waits`), each counted once where it
starts. The split by innermost span goes to standard error."""
import sys

from bench.metrics import _spans


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops or not tr.host_ops:
        return None
    parts = _spans.host_waits(tr)
    print("[bench] host_wait_ms by span: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(parts.items(),
                                          key=lambda kv: -kv[1])),
        file=sys.stderr)
    return sum(parts.values())
