"""wire_agg's share of its roofline: the PS's decode of the C packed
uplink payloads of a leaf into the Eq.-7 aggregate."""
from bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "wire_agg", family=r"\bwire_agg_kernel\b",
                 primary=r"\bwire_agg_kernel\b")
