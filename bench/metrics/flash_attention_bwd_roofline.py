"""The flash-attention backward's share of its roofline: every device
function of one backward call (the rowsum prep, the dK/dV and dQ passes,
the head groups' reduction where the grid splits them)."""
from bench.metrics._roofline import share


def read(ctx):
    return share(
        ctx, "flash_attention_bwd",
        family=(r"\b(prep_tc_kernel|dkdv_tc_kernel|dq_tc_kernel)\b"
                r"|\(anonymous namespace\)::reduce_kernel\b"),
        primary=r"\bdkdv_tc_kernel\b")
