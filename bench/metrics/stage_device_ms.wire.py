"""Device milliseconds a round of the ops launched inside the wire's
stage ranges: Uplink, Aggregate and Downlink."""
from bench import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    s = trace.stage_s(ctx.trace, ("Uplink", "Aggregate", "Downlink"))
    return None if s is None else 1e3 * s / ctx.trace.rounds
