"""Device milliseconds a round of the ops launched inside the mesh
engine's `LocalUpdate.train.fwd` spans: each gradient call's loss
forward, the activations it keeps for the backward."""
from bench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "LocalUpdate.train.fwd")
