"""Device milliseconds a round of the ops launched inside the
`LocalUpdate` stage's range (local training, Eq. 8, the scoring)."""
from bench import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    s = trace.stage_s(ctx.trace, ("LocalUpdate",))
    return None if s is None else 1e3 * s / ctx.trace.rounds
