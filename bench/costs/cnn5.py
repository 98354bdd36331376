"""Model FLOPs of the paper's 5-layer CNN [9] (conv 3x3 c, pool, conv 3x3
2c, pool, conv 3x3 2c, dense -> 4c, dense -> classes; c = width
multiplier), two a multiply-add, counted in the convolutions and the
dense products only, as torch.utils.flop_counter counts them. Nothing is
counted twice: no recompute."""


def _layers(height: int, width: int, channels: int, classes: int,
            width_mult: int) -> list[int]:
    """Forward FLOPs of one sample, layer by layer."""
    c1, c2, c3 = width_mult, 2 * width_mult, 2 * width_mult
    h1, w1 = height, width
    h2, w2 = h1 // 2, w1 // 2
    h3, w3 = h2 // 2, w2 // 2
    feat, hidden = h3 * w3 * c3, 4 * width_mult
    return [2 * h1 * w1 * c1 * 9 * channels,
            2 * h2 * w2 * c2 * 9 * c1,
            2 * h3 * w3 * c3 * 9 * c2,
            2 * feat * hidden,
            2 * hidden * classes]


def forward_flops(height: int, width: int, channels: int, classes: int,
                  width_mult: int) -> int:
    return sum(_layers(height, width, channels, classes, width_mult))


def train_flops(height: int, width: int, channels: int, classes: int,
                width_mult: int) -> int:
    """Forward and backward of one sample: the backward computes each
    layer's weight gradient and the gradient of its input, except the
    first layer's input (the image), which needs none."""
    layers = _layers(height, width, channels, classes, width_mult)
    return sum(layers) + 2 * sum(layers) - layers[0]


def round_flops(cfg: dict, traffic: dict) -> int:
    """One M-DSL round of the paper engine: every worker's local epochs
    (forward and backward of each minibatch sample), and the forward
    passes that score on the shared set D_g: every worker before and
    after its local update, and the global model once."""
    dims = (cfg["height"], cfg["width"], cfg["channels"], cfg["num_classes"],
            cfg["width_mult"])
    C, n, bs = traffic["workers"], traffic["n_local"], traffic["batch_size"]
    bs = min(bs, n)
    samples = C * traffic["local_epochs"] * (n // bs) * bs
    scored = (2 * C + 1) * traffic["n_global"]
    return samples * train_flops(*dims) + scored * forward_flops(*dims)
