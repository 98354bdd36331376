"""Device milliseconds a round of the ops launched inside the
`LocalUpdate.eq8` spans: the round-level Eq. 8 displacement and the
Byzantine corruption. Where no Eq. 8 runs after the training (FedAvg,
Eq. 8 every step), the span is not opened."""
from bench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "LocalUpdate.eq8")
