"""Device milliseconds a round in the worker-batched convolution's three
device functions (`worker_conv_fwd`, `worker_conv_dgrad`,
`worker_conv_wgrad`): CNN5's convolutions, all C workers a launch.
Nothing where the program counted no launch of its operators (a program
without the kernel). The launches a round, as the program counted them
and as the trace holds them, go to standard error."""
import re
import sys

OPERATORS = ("worker_conv", "worker_conv_dgrad", "worker_conv_wgrad")
FAMILY = re.compile(r"\bworker_conv_(fwd|dgrad|wgrad)\b")


def read(ctx):
    tr = ctx.trace
    counted = sum(ctx.counts.get(k, 0) for k in OPERATORS)
    if tr is None or not tr.ops or not counted:
        return None
    ops = [op for op in tr.ops if FAMILY.search(op.name)]
    print(f"[bench] worker_conv launches a round: {counted / tr.rounds:.1f} "
          f"counted, {len(ops) / tr.rounds:.1f} traced", file=sys.stderr)
    if not ops:
        return None
    return 1e-3 * sum(op.end - op.start for op in ops) / tr.rounds
