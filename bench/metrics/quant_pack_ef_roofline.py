"""quant_pack_ef's share of its roofline: the fused int-b uplink pass
(quantize, pack, error feedback) for all C workers of a leaf."""
from bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "quant_pack_ef",
                 family=r"quant_pack_kernel<\d+,\s*(true|1)\b",
                 primary=r"quant_pack_kernel<\d+,\s*(true|1)\b")
