"""pso_update's share of its roofline: Eq. 8 over the W stacked workers,
one launch a leaf."""
from bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "pso_update", family=r"\bpso_update_kernel\b",
                 primary=r"\bpso_update_kernel\b")
