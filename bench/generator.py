"""The one generator of the benchmark's inputs. A workload's `traffic`
object names its `kind` and its parameters; everything is drawn from
`--seed` by torch.Generators on the device (salted per stream, so data,
weights and each round's draws never share a stream), and the same seed
gives the same inputs. Both the port and the plain reference are handed
what this module makes.

kinds:
  fleet   C workers of labelled images (class prototypes, low-passed,
          times a contrast, plus noise), each worker's labels drawn
          from a Dirichlet(alpha) mix of the classes (the paper's
          non-i.i.d. case I), a shared scoring set D_g of uniform labels,
          and each round's Algorithm-1 draws: the Eq.-8 coefficients,
          the local epochs' permutations, the wire's rounding seeds
  tokens  W workers' (B, S) batches of uniform token ids, an eval batch,
          and each round's draws (Eq.-8 coefficients, wire seeds)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SALT = {"data": 1, "params": 2, "draws": 3, "labels": 4}
IMAX = 2**31 - 1


def stream(seed: int, name: str, device) -> torch.Generator:
    """The seed's torch.Generator for one stream of draws (any whole
    seed >= 0)."""
    state = np.random.SeedSequence([int(seed), SALT[name]]).generate_state(
        2, dtype=np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def _blur(x: torch.Tensor) -> torch.Tensor:
    """A 3x3 box blur with edge padding, NHWC."""
    h = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    return F.avg_pool2d(h, 3, stride=1).permute(0, 2, 3, 1)


def fleet_data(t: dict, cfg: dict, seed: int, device) -> dict:
    """x (C, n, H, W, ch), y (C, n), gx (n_g, H, W, ch), gy (n_g,)."""
    gen = stream(seed, "data", device)
    H, W, ch, L = cfg["height"], cfg["width"], cfg["channels"], \
        cfg["num_classes"]
    C, n, ng = t["workers"], t["n_local"], t["n_global"]
    proto = _blur(_blur(torch.randn((L, H, W, ch), generator=gen,
                                    device=device)))
    proto = (proto - proto.mean(dim=(1, 2, 3), keepdim=True)) / (
        proto.std(dim=(1, 2, 3), keepdim=True, unbiased=False) + 1e-6)
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), SALT["labels"]]))
    props = rng.dirichlet(np.full(L, float(t["dirichlet_alpha"])), size=C)
    probs = torch.as_tensor(props + 1e-12, dtype=torch.float32, device=device)
    y = torch.multinomial(probs, n, replacement=True, generator=gen)
    gy = torch.randint(0, L, (ng,), generator=gen, device=device)

    def images(labels):
        base = proto[labels]
        contrast = 1.0 + t["contrast"] * torch.randn(
            labels.shape + (1, 1, 1), generator=gen, device=device)
        return base * contrast + t["noise"] * torch.randn(
            base.shape, generator=gen, device=device)
    return {"x": images(y), "y": y, "gx": images(gy), "gy": gy}


def cnn5_params(cfg: dict, seed: int, device) -> dict:
    """He-normal convolution and dense weights (HWIO, (in, out)), zero
    biases: the paper's CNN at the configuration's widths."""
    gen = stream(seed, "params", device)
    c = cfg["width_mult"]
    feat = (cfg["height"] // 4) * (cfg["width"] // 4) * 2 * c
    shapes = {"conv1": (3, 3, cfg["channels"], c), "conv2": (3, 3, c, 2 * c),
              "conv3": (3, 3, 2 * c, 2 * c), "fc1": (feat, 4 * c),
              "fc2": (4 * c, cfg["num_classes"])}
    out = {}
    for name, shape in shapes.items():
        fan_in = int(np.prod(shape[:-1]))
        w = torch.randn(shape, generator=gen, device=device) * float(
            np.sqrt(2.0 / fan_in))
        out[name] = {"w": w, "b": torch.zeros(shape[-1], device=device)}
    return out


def transformer_shapes(cfg: dict) -> dict:
    """{path: (shape, dtype name)} of the configuration's `layout`: the
    embedding and final norm, and each layer's leaves stacked over the
    layers (norm scales in f32, every matrix in the served dtype)."""
    L, D, H, K = (cfg["num_hidden_layers"], cfg["hidden_size"],
                  cfg["num_attention_heads"], cfg["num_key_value_heads"])
    hd = cfg.get("head_dim") or D // H
    Fd, V, dt = cfg["intermediate_size"], cfg["vocab_size"], \
        cfg["torch_dtype"]
    return {"embed/table": ((V, D), dt),
            "final_norm/scale": ((D,), "float32"),
            "groups/b0/temporal/norm/scale": ((L, D), "float32"),
            "groups/b0/temporal/wq": ((L, D, H, hd), dt),
            "groups/b0/temporal/wk": ((L, D, K, hd), dt),
            "groups/b0/temporal/wv": ((L, D, K, hd), dt),
            "groups/b0/temporal/wo": ((L, H, hd, D), dt),
            "groups/b0/mlp/norm/scale": ((L, D), "float32"),
            "groups/b0/mlp/wi": ((L, D, Fd), dt),
            "groups/b0/mlp/wu": ((L, D, Fd), dt),
            "groups/b0/mlp/wo": ((L, Fd, D), dt)}


def transformer_params(cfg: dict, seed: int, device) -> dict:
    """Every matrix and the embedding N(0, initializer_range^2) in the
    served dtype (drawn in f32 a leaf at a time, then cast), norm scales
    1 in f32 (`transformer_shapes`)."""
    gen = stream(seed, "params", device)
    std = cfg["initializer_range"]
    out: dict = {}
    for path, (shape, dt) in transformer_shapes(cfg).items():
        if dt == "float32":
            leaf = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            leaf = torch.randn(shape, generator=gen, device=device).mul_(
                std).to(getattr(torch, dt))
        node = out
        *parents, name = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return out


def paper_draws(gen: torch.Generator, t: dict, leaves: int,
                device) -> dict:
    """One paper round's draws: coefficients (C, 3) (c0 ~ U(0, 1), c1, c2
    ~ N(0, 1)), each worker's epoch permutations (C, E, n), uplink seeds
    (C, L) and downlink seeds (L,), int32."""
    C, E, n = t["workers"], t["local_epochs"], t["n_local"]
    c0 = torch.rand(C, generator=gen, device=device)
    c12 = torch.randn(C, 2, generator=gen, device=device)
    return {"coeffs": torch.cat([c0[:, None], c12], dim=1),
            "perms": torch.rand((C, E, n), generator=gen,
                                device=device).argsort(dim=-1),
            "up_seeds": torch.randint(0, IMAX, (C, leaves), generator=gen,
                                      device=device, dtype=torch.int32),
            "down_seeds": torch.randint(0, IMAX, (leaves,), generator=gen,
                                        device=device, dtype=torch.int32)}


def token_round(gen: torch.Generator, t: dict, vocab: int, leaves: int,
                device) -> dict:
    """One mesh round's inputs: the workers' batches (W, B, S), the eval
    batch (B, S) (labels: the tokens shifted one to the left), the Eq.-8
    coefficients (W, 3) and the wire's seeds."""
    W, B, S = t["workers"], t["batch"], t["seq_len"]

    def batch(lead):
        toks = torch.randint(0, vocab, lead + (B, S), generator=gen,
                             device=device)
        return {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
    c0 = torch.rand(W, generator=gen, device=device)
    c12 = torch.randn(W, 2, generator=gen, device=device)
    return {"batch": batch((W,)), "eval": batch(()),
            "coeffs": torch.cat([c0[:, None], c12], dim=1),
            "up_seeds": torch.randint(0, IMAX, (W, leaves), generator=gen,
                                      device=device, dtype=torch.int32),
            "down_seeds": torch.randint(0, IMAX, (leaves,), generator=gen,
                                        device=device, dtype=torch.int32)}
