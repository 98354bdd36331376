"""The share of the traced window in which no device operation runs
(the union of the trace's kernel, copy and fill intervals)."""
from bench import trace


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / tr.window_s)
