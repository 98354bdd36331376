"""quant_pack's share of its roofline: the PS's quantized downlink, one
launch a leaf (C = 1)."""
from bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "quant_pack",
                 family=r"quant_pack_kernel<\d+,\s*(false|0)\b",
                 primary=r"quant_pack_kernel<\d+,\s*(false|0)\b")
