"""dequant_unpack's share of its roofline: the workers' decode of the
quantized downlink, one launch a leaf (C = 1)."""
from bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "dequant_unpack", family=r"\bdequant_kernel\b",
                 primary=r"\bdequant_kernel\b")
