"""Device milliseconds a round of the ops launched inside the
`GlobalLoss` span: the global model's forward on the eval set."""
from bench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "GlobalLoss")
