"""Device milliseconds a round of the ops launched inside the
`LocalUpdate.score` spans: every scoring forward of the workers on D_g
(the paper engine's before and after the local update)."""
from bench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "LocalUpdate.score")
