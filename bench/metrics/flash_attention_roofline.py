"""The flash-attention forward's share of its roofline: the training
forwards (with the log-sum-exp), their recompute under activation
checkpointing, and the scoring forwards."""
from bench.metrics._roofline import share


def read(ctx):
    return share(ctx, "flash_attention",
                 family=r"\b(fwd_tc_kernel|flash_attention_kernel)\b",
                 primary=r"\b(fwd_tc_kernel|flash_attention_kernel)\b")
