"""Device milliseconds a round of the ops launched inside the
`LocalUpdate.train` span: local training, forward and backward (per-step
Eq. 8 too, where it runs inside the steps)."""
from bench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "LocalUpdate.train")
