"""Model FLOPs of a dense decoder-only transformer with grouped-query
attention, a gated MLP and a tied output head, two a multiply-add in the
products only, as torch.utils.flop_counter counts them. Attention is
counted as dense attention computes it, every (query, key) pair of the
S x S scores (as PaLM's 6N + 12 L H Q T counts it); recompute under
activation checkpointing is not counted."""


def matmul_params(cfg: dict) -> int:
    """Weights that multiply each token: q, k, v and the output
    projection, the gated MLP, and the tied head (the embedding lookup
    itself multiplies nothing)."""
    d, H, K = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    layer = d * hd * (H + 2 * K) + H * hd * d + 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * layer + cfg["vocab_size"] * d


def forward_flops(cfg: dict, B: int, S: int) -> int:
    """One forward pass over a (B, S) batch."""
    H = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // H
    attn = 4 * B * H * S * S * hd * cfg["num_hidden_layers"]
    return 2 * B * S * matmul_params(cfg) + attn


def train_flops(cfg: dict, B: int, S: int) -> int:
    """Forward and backward: every product's backward forms the gradient
    of both its operands (the first layer's input is the embedding,
    which trains), so twice the forward."""
    return 3 * forward_flops(cfg, B, S)


def round_flops(cfg: dict, traffic: dict) -> int:
    """One M-DSL round of the mesh engine: each of the W workers' local
    steps on its (B, S) batch, then the forward passes that score on the
    eval batch: every worker's updated model and the global one."""
    W, B, S = traffic["workers"], traffic["batch"], traffic["seq_len"]
    steps = traffic.get("local_steps", 1)
    return (W * steps * train_flops(cfg, B, S)
            + (W + 1) * forward_flops(cfg, B, S))
