"""A dense decoder-only transformer in plain PyTorch, as the Llama-style
configuration file describes it (SmolLM-360M): token embedding, per layer
a pre-norm grouped-query attention with rotary positions (theta, the
rotate-half layout) and a pre-norm gated MLP (silu(h Wi) * (h Wu)) Wo,
then a final RMSNorm and the tied head. Products in bfloat16 with f32
accumulation; norms, rotary angles, the attention's scores and softmax,
and the loss in float32. Dense attention: the causal S x S scores.

Every product's operands are bf16 values (or fp8 values in the
control), which TF32 holds exactly, so products in f32 may run on TF32
tensor cores with f32 accumulation and lose nothing.

Parameters are the tree the benchmark makes (configs' `layout`):
embed/table (V, D), final_norm/scale (D,), and, stacked over the L
layers, groups/b0/temporal/{norm/scale, wq (D, H, hd), wk, wv (D, K, hd),
wo (H, hd, D)} and groups/b0/mlp/{norm/scale, wi, wu (D, F), wo (F, D)}.

`precision="fp8"` is the control: every product's two operands rounded
to float8 e4m3 (a scale per tensor, its largest magnitude at 448) before
the product."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.abs().amax().float().clamp(min=1e-30)
    s = amax / 448.0
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    return torch.matmul(a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale.to(F32)).to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, N, hd), positions 0..S-1, the rotate-half layout."""
    S, half = x.shape[1], x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=F32, device=x.device)
                      * (math.log(theta) / half))
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def attention(q, k, v, precision: str) -> torch.Tensor:
    """Causal GQA: q (B, S, H, hd), k, v (B, S, K, hd) -> (B, S, H, hd).
    Scores and softmax in f32, the probabilities cast to v's dtype."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    qh = q.permute(0, 2, 1, 3)
    kh = k.repeat_interleave(rep, dim=2).permute(0, 2, 3, 1)
    vh = v.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    s = mm(qh.to(F32), kh.to(F32), precision) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    out = mm(p.to(v.dtype).to(F32), vh.to(F32), precision)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def layer(x: torch.Tensor, p: dict, cfg: dict, precision: str
          ) -> torch.Tensor:
    """One decoder layer; p holds that layer's slices of the stacks."""
    eps, D = cfg["rms_norm_eps"], x.shape[-1]
    a = p["temporal"]
    h = rmsnorm(x, a["norm"]["scale"], eps)
    B, S = h.shape[:2]
    q = mm(h, a["wq"].reshape(D, -1), precision).reshape(B, S, *a["wq"].shape[1:])
    k = mm(h, a["wk"].reshape(D, -1), precision).reshape(B, S, *a["wk"].shape[1:])
    v = mm(h, a["wv"].reshape(D, -1), precision).reshape(B, S, *a["wv"].shape[1:])
    theta = cfg["rope_theta"]
    o = attention(rope(q, theta), rope(k, theta), v, precision)
    x = x + mm(o.reshape(B, S, -1), a["wo"].reshape(-1, D), precision)
    m = p["mlp"]
    h = rmsnorm(x, m["norm"]["scale"], eps)
    gate = F.silu(mm(h, m["wi"], precision))
    return x + mm(gate * mm(h, m["wu"], precision), m["wo"], precision)


def _layers(params: dict, L: int) -> list[dict]:
    """The L layers' slices of the stacked group tree (one unbind a
    leaf, so autograd stacks each leaf's gradient once)."""
    def walk(node):
        if isinstance(node, dict):
            parts = {k: walk(v) for k, v in node.items()}
            return [{k: parts[k][i] for k in node} for i in range(L)]
        return list(torch.unbind(node, 0))
    return walk(params["groups"]["b0"])


def ce_sum(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
           cfg: dict, precision: str = "bf16", remat: bool = False
           ) -> torch.Tensor:
    """The summed next-token cross-entropy of rows (B, S): the logits at
    position t against labels[t + 1], in f32."""
    L = cfg["num_hidden_layers"]
    x = F.embedding(tokens, params["embed"]["table"])
    for p in _layers(params, L):
        if remat:
            x = checkpoint(layer, x, p, cfg, precision, use_reentrant=False)
        else:
            x = layer(x, p, cfg, precision)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["rms_norm_eps"])
    logits = mm(x, params["embed"]["table"].t(), precision)[:, :-1]
    lp = torch.log_softmax(logits.to(F32), dim=-1)
    return -lp.gather(-1, labels[:, 1:, None])[..., 0].sum()


def loss(params: dict, tokens, labels, cfg: dict, precision: str = "bf16",
         rows: int = 2) -> torch.Tensor:
    """Mean next-token cross-entropy over a (B, S) batch, `rows` rows at
    a time."""
    total = torch.zeros((), dtype=F32, device=tokens.device)
    with torch.no_grad():
        for r in range(0, tokens.shape[0], rows):
            total += ce_sum(params, tokens[r:r + rows], labels[r:r + rows],
                            cfg, precision)
    return total / (tokens.shape[0] * (tokens.shape[1] - 1))


def loss_grads(params: dict, tokens, labels, cfg: dict,
               precision: str = "bf16", rows: int = 2
               ) -> tuple[torch.Tensor, list]:
    """The mean loss and its gradient (leaves in sorted-path order, f32)
    over a (B, S) batch, `rows` rows at a time, each layer recomputed in
    the backward."""
    from bench.reference.tree import leaves, like
    flat = [t.detach().requires_grad_() for t in leaves(params)]
    tree = like(params, flat)
    n = tokens.shape[0] * (tokens.shape[1] - 1)
    total = torch.zeros((), dtype=F32, device=tokens.device)
    acc = [torch.zeros_like(t, dtype=F32) for t in flat]
    for r in range(0, tokens.shape[0], rows):
        with torch.enable_grad():
            part = ce_sum(tree, tokens[r:r + rows], labels[r:r + rows], cfg,
                          precision, remat=True) / n
            gs = torch.autograd.grad(part, flat)
        total += part.detach()
        for a, g in zip(acc, gs):
            a += g.to(F32)
        del gs
    return total, acc
