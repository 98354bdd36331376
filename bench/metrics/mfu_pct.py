"""The whole round's share of the card's peak: the round's model FLOPs
(bench/costs, from the configuration and the traffic; no recompute) over
the untraced window's seconds a round and the peak of the
configuration's dtype."""


def read(ctx):
    if not ctx.round_s or not ctx.flops_per_round:
        return None
    return 100.0 * ctx.flops_per_round / ctx.round_s / ctx.peak_flops
