"""Device milliseconds a round of the ops launched inside the mesh
engine's `LocalUpdate.train.bwd` spans: each gradient call's
`torch.autograd.grad`, with any recompute."""
from bench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "LocalUpdate.train.bwd")
