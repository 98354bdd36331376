"""Shared transformer layers of the port (init/apply pairs over dict
params), as the JAX package's `models/layers.py`.

Conventions, as there: params are nested dicts of tensors; x is
(B, S, D) and attention internals (B, S, H, hd); matmuls run in the
config dtype, norms, rotary angles and softmax in f32. An init function
takes a `torch.Generator`, the device and `lead`, a tuple of leading
dims (the stacked layer groups), and draws one leaf at a time (a large
leaf in blocks of rows: `normal_init`).

Attention over a whole sequence (train, prefill) goes through
`kernels.flash_attention` (the CUDA kernel on a card, the plain version
on the CPU) where the reference calls its XLA twin `chunked_attention`;
when a gradient is wanted (training) that is its autograd Function
(forward kernel with the log-sum-exp, backward kernel), where the
reference differentiates `chunked_attention` through XLA.
Decode attends one token over the cache with a grouped product, as the
reference does; cross-attention (`memory_kv`) attends the encoder memory
through the flash kernel in every mode, decode's one query included.
Caches are written in place (`index_copy_`) and returned; their `pos`
is a Python int, so decode never syncs the host.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.sharding.rules import is_dtensor, shard

PyTree = Any
F32 = torch.float32


def cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# f32 elements of one draw: a leaf larger than this is drawn a block of
# whole rows at a time into the leaf itself, so that no f32 copy of a
# large stacked leaf (Qwen3-MoE's (48, 128, 2048, 768) expert weights:
# 38.7 GB in f32) ever exists next to the weights already drawn
DRAW_ELEMENTS = 1 << 26


# what `normal_init` calls in its place while set (`draw_hook`): the
# shard-wise draw of `launch.steps.init_placed`
_DRAW_HOOK = None


@contextlib.contextmanager
def draw_hook(fn):
    """Inside, every `normal_init(gen, shape, scale, dtype, device)` call
    returns fn(gen, shape, scale, dtype, device) instead."""
    global _DRAW_HOOK
    prev, _DRAW_HOOK = _DRAW_HOOK, fn
    try:
        yield
    finally:
        _DRAW_HOOK = prev


def normal_init(gen: Optional[torch.Generator], shape: tuple, scale: float,
                dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, 1) drawn in f32, times `scale`, then cast to `dtype`. One
    rule for every leaf: the leaf, seen as rows of its last dim, is
    drawn in blocks of up to DRAW_ELEMENTS elements of whole rows (at
    least one row), each block its own `randn` call. On the "meta"
    device, the shape and dtype only."""
    if _DRAW_HOOK is not None:
        return _DRAW_HOOK(gen, shape, scale, dtype, device)
    return normal_shard(gen, shape, scale, dtype, device)


def normal_shard(gen: Optional[torch.Generator], shape: tuple,
                 scale: float, dtype: torch.dtype, device,
                 box: Optional[tuple] = None) -> torch.Tensor:
    """`normal_init`'s draw of a `shape` leaf, of which only the slice
    `box` ((start, stop) a dim; None: the whole leaf) is kept: every
    block is drawn as the whole draw draws it, so the slice's values are
    the whole leaf's, and no more than the slice and one block exist."""
    shape = tuple(shape)
    if box is None:
        box = tuple((0, n) for n in shape)
    out = torch.empty(tuple(e - b for b, e in box), dtype=dtype,
                      device=device)
    if out.device.type == "meta" or math.prod(shape) == 0:
        return out
    cols = shape[-1] if shape else 1
    n_rows = math.prod(shape[:-1]) if shape else 1
    rows = out.view(-1, out.shape[-1]) if out.dim() else out.view(1, 1)
    whole = all(b == 0 and e == n for (b, e), n in zip(box, shape))
    step = max(1, DRAW_ELEMENTS // cols)
    for r0 in range(0, n_rows, step):
        blk = torch.randn((min(step, n_rows - r0), cols), generator=gen,
                          device=out.device, dtype=F32)
        if whole:
            rows[r0:r0 + blk.shape[0]] = blk.mul_(scale)
            continue
        # the block's rows that fall in the box, and where they go
        r = torch.arange(r0, r0 + blk.shape[0], device=out.device)
        keep = torch.ones_like(r, dtype=torch.bool)
        pos = torch.zeros_like(r)
        for d in range(len(shape) - 2, -1, -1):
            i, r = r % shape[d], r // shape[d]
            b, e = box[d]
            keep &= (i >= b) & (i < e)
            pos = pos + (i - b) * math.prod(
                e2 - b2 for b2, e2 in box[d + 1:-1])
        sel = keep.nonzero()[:, 0]
        if sel.numel():
            c0, c1 = box[-1] if shape else (0, 1)
            rows.index_copy_(0, pos[sel], blk[sel, c0:c1].mul_(scale).to(
                dtype))
    return out


def dense_init(gen: Optional[torch.Generator], shape: tuple, fan_in: int,
               dtype: torch.dtype, device, lead: tuple = ()
               ) -> torch.Tensor:
    """N(0, 1/fan_in) drawn in f32, then cast (the reference's
    `dense_init`; fan_in is its `shape[in_axis]`), by `normal_init`'s
    rule."""
    return normal_init(gen, tuple(lead) + tuple(shape),
                       1.0 / math.sqrt(fan_in), dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device, lead: tuple = ()) -> PyTree:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=F32, device=device)}


def rmsnorm(params: PyTree, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embedding_init(gen, vocab: int, d: int, dtype, device) -> PyTree:
    return {"table": normal_init(gen, (vocab, d), 0.01, dtype, device)}


def embed(params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of `tokens` (B, S) in the table (V, D). A table sharded
    over the vocab is never gathered: each rank looks its tokens up in
    its own rows and the rows are summed over the vocab's mesh dims
    (`_vocab_parallel`), where the reference's `jnp.take` on the
    ("vocab", "embed") table leaves the same masked lookup and sum to
    XLA's partitioner."""
    tbl = shard(params["table"], ("vocab", "embed"))
    if is_dtensor(tbl) and any(p.is_shard(0) for p in tbl.placements):
        return shard(_vocab_parallel(tbl, tokens), ("batch", "seq", "embed"))
    return shard(F.embedding(tokens, tbl), ("batch", "seq", "embed"))


def vocab_shard_lookup(table: torch.Tensor, tokens: torch.Tensor, lo: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One vocab shard's part of a lookup: `table` holds rows [lo, lo +
    rows) of the whole. Returns the rows of the tokens in the shard, zero
    for the others (summed over the shards this is the lookup, bitwise:
    one real row and zeros), and the index its gradient scatters by
    (`vocab_shard_grad`): the token's local row, or `rows` for a token
    outside the shard. Device-side masks only: no host read, so it runs
    on fake tensors."""
    rows = table.shape[0]
    idx = tokens - lo
    keep = (idx >= 0) & (idx < rows)
    out = torch.where(keep[..., None],
                      F.embedding(torch.where(keep, idx, 0), table), 0)
    return out, torch.where(keep, idx, rows)


def vocab_shard_grad(g: torch.Tensor, idx: torch.Tensor, rows: int
                     ) -> torch.Tensor:
    """The shard's table gradient from the output gradient g (..., D):
    F.embedding's own backward over rows + 1, the extra row taking the
    tokens outside the shard and then cut off. A row's contributions
    come in the same order as in the whole table's backward, so the
    result is bitwise its rows [lo, lo + rows)."""
    return torch.ops.aten.embedding_dense_backward(
        g, idx, rows + 1, -1, False)[:rows]


class _VocabLookup(torch.autograd.Function):
    """`vocab_shard_lookup` on one rank's vocab shard, whose backward
    scatters the output's gradient into the shard's own rows."""

    @staticmethod
    def forward(ctx, table, tokens, lo: int):
        out, idx = vocab_shard_lookup(table, tokens, lo)
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return vocab_shard_grad(g.contiguous(), idx, ctx.rows), None, None


def _vocab_parallel(tbl, tokens):
    """The lookup on the table DTensor `tbl` sharded over the vocab (dim
    0) on some mesh dims. The tokens are this rank's, as laid out
    (replicated over the dims that shard the table); the output is a
    DTensor laid out as the tokens, with the table's embed dim shards.
    The table's gradient lands on its own shards: Shard over the dims
    that shard it, a partial sum over the dims that split the tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.sharding import collectives
    mesh = tbl.device_mesh
    vocab = collectives.shard_dims(tbl.placements, 0)
    cut = {m for m, p in enumerate(tbl.placements) if p.is_shard()}
    if is_dtensor(tokens):
        tokens = tokens.redistribute(mesh, [
            Replicate() if m in cut else p
            for m, p in enumerate(tokens.placements)])
        tok_pl, tokens = tokens.placements, tokens.to_local()
    else:
        tok_pl = [Replicate()] * mesh.ndim
    grad_pl = [p if p.is_shard() else
               Partial() if tok_pl[m].is_shard() else Replicate()
               for m, p in enumerate(tbl.placements)]
    lo, _ = collectives.offset(tbl.shape[0], mesh, vocab)
    out = _VocabLookup.apply(tbl.to_local(grad_placements=grad_pl), tokens,
                             lo)
    # summed over the vocab's dims; every rank there sees the same tokens,
    # so the sum's gradient is the same on each: no communication back
    out = collectives.gather_sum(out, mesh, (), vocab)
    out_pl = [Shard(tokens.ndim) if p.is_shard(1) else tok_pl[m]
              for m, p in enumerate(tbl.placements)]
    # the whole output's shape, contiguous: from_local would scale the
    # stride of a size-1 dim (decode's seq) with the batch's shards, and
    # such strides send a later matmul to a batched product
    shape = list(out.shape)
    for m, p in enumerate(out_pl):
        if p.is_shard():
            shape[p.dim] *= mesh.size(m)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def unembed(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: (B,S,D) @ (V,D)^T -> (B,S,V), in x's dtype."""
    tbl = shard(params["table"], ("vocab", "embed"))
    return shard(torch.matmul(x, tbl.t()), ("batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,). Applies RoPE in f32."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=F32, device=x.device) *
                      (math.log(theta) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(F32) * freqs            # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA; full-causal / sliding-window; train, prefill, decode)
# ---------------------------------------------------------------------------

def attention_init(gen, cfg, device, lead: tuple = ()) -> PyTree:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, k = cfg.num_heads, cfg.num_kv_heads
    dt = cdtype(cfg)
    return {
        "norm": rmsnorm_init(d, device, lead),
        "wq": dense_init(gen, (d, h, hd), d, dt, device, lead),
        "wk": dense_init(gen, (d, k, hd), d, dt, device, lead),
        "wv": dense_init(gen, (d, k, hd), d, dt, device, lead),
        "wo": dense_init(gen, (h, hd, d), h, dt, device, lead),
    }


def project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,D) x (D,N,hd) -> (B,S,N,hd) as one matmul. A DTensor product
    whose N x hd columns come out sharded over more shards than N heads
    (Qwen3's 4 kv heads on a 16-way model axis) is gathered over them
    first: DTensor cannot split such columns into (N, hd)."""
    B, S, D = h.shape
    w2 = w.reshape(D, -1)
    N = w.shape[1]
    if is_dtensor(w2) and any(N % n for n in w2.device_mesh.shape):
        # the weight's gradient may come back column-sharded alike: laid
        # out as the weight before the reshape's backward splits it
        w2 = _LaidOut.apply(w2)
    y = torch.matmul(h, w2)
    if is_dtensor(y) and N % _shards(y, y.ndim - 1):
        from torch.distributed.tensor import Replicate
        y = y.redistribute(y.device_mesh, [
            Replicate() if p.is_shard(y.ndim - 1) else p
            for p in y.placements])
    return y.reshape(B, S, *w.shape[1:])


def _shards(x, dim: int) -> int:
    """How many shards a DTensor's dim is split into."""
    n = 1
    for m, p in enumerate(x.placements):
        if p.is_shard(dim):
            n *= x.device_mesh.size(m)
    return n


class _LaidOut(torch.autograd.Function):
    """The identity on a DTensor whose gradient goes back laid out as
    the input was."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cur: int, window: int) -> torch.Tensor:
    """One step over the cache (layers.py:273-304): q (B,S,H,hd), k/v
    (B,T,K,hd); `cur` is the new token's absolute position. Scores and
    softmax in f32, p cast to the cache dtype before the PV product.

    A DTensor cache sharded over batch or kv heads (not over its
    sequence) attends on each rank's shard, q laid out alike: the grouped
    products would otherwise flatten two sharded dims, which DTensor
    refuses in some versions."""
    if is_dtensor(k) and not any(p.is_shard(1) for p in k.placements):
        from torch.distributed.tensor.experimental import local_map
        pl = list(k.placements)      # a list: one output's placements
        return local_map(
            lambda q, k, v: _decode_attention(q, k, v, cur, window),
            out_placements=pl, in_placements=(pl, pl, pl),
            device_mesh=k.device_mesh, redistribute_inputs=True)(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    kv_pos = torch.arange(T, device=q.device)
    if window and T <= window:
        # ring: slot j holds position p iff p % T == j; every slot is
        # valid once the ring has wrapped
        mask = None if cur >= T else kv_pos <= cur % T
    else:
        mask = kv_pos <= cur
        if window:
            mask = mask & (kv_pos > cur - window)
    qg = q.reshape(B, S, K, H // K, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg.to(F32), k.to(F32))
    s = s / math.sqrt(hd)
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).to(F32),
                       v.to(F32))
    return out.reshape(B, S, H, hd)


def attention_apply(params: PyTree, x: torch.Tensor, cfg, *, mode: str,
                    layer_cache: Optional[PyTree] = None, window: int = 0,
                    memory_kv: Optional[tuple] = None
                    ) -> tuple[torch.Tensor, Optional[PyTree]]:
    """One attention sub-block (pre-norm; the caller adds the residual).
    mode: "train" | "prefill" | "decode" | "encode" (bidirectional: RoPE
    from position 0, no cache, no causal mask).

    layer_cache: {"k", "v": (B, S_cache, K, hd) (S_cache = window for the
    sliding-window ring), "pos": int tokens already written}. Returns
    (out, new_cache); the cache tensors are updated in place.

    Cross-attention: memory_kv = (k, v), each (B, M, K, hd), the memory's
    keys and values (`Transformer._memory_kv`). q is projected from x and
    gets no RoPE; there is no cache; every mode attends all M keys
    through the flash kernel, non-causally (decode too: Sq = 1 over M)."""
    if mode not in ("train", "prefill", "decode", "encode"):
        raise ValueError(f"attention mode {mode!r}")
    B, S, D = x.shape
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    q = project(h, params["wq"])
    if memory_kv is not None:
        out = flash_attention(q, memory_kv[0], memory_kv[1], causal=False)
        return _out_proj(params, out), None
    if mode == "decode" and layer_cache is None:
        raise ValueError("decode attends over a cache: pass layer_cache")
    k = project(h, params["wk"])
    v = project(h, params["wv"])

    pos = 0 if layer_cache is None else int(layer_cache["pos"])
    positions = pos + torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # act_* names: activation head sharding is decoupled from the weight
    # head sharding so serving can seq-shard the KV cache (act heads
    # replicated) while keeping projection weights TP-sharded
    q = shard(q, ("batch", "seq", "act_heads", "head_dim"))
    k = shard(k, ("batch", "seq", "act_kv_heads", "head_dim"))
    v = shard(v, ("batch", "seq", "act_kv_heads", "head_dim"))

    new_cache = None
    if layer_cache is not None and mode in ("prefill", "decode"):
        ck, cv = layer_cache["k"], layer_cache["v"]
        cache_len = ck.shape[1]
        kk, vv, idx = k, v, positions[0, :] % cache_len
        rows = range(pos, pos + S)
        if mode == "prefill" and window and cache_len < S:
            # keep the last `cache_len` tokens in the ring
            kk, vv = k[:, -cache_len:], v[:, -cache_len:]
            idx = positions[0, -cache_len:] % cache_len
            rows = rows[-cache_len:]
        slots = [r % cache_len for r in rows]      # idx, on the host
        write_cache(ck, idx, kk, slots)
        write_cache(cv, idx, vv, slots)
        new_cache = {"k": ck, "v": cv, "pos": pos + S}

    if mode == "decode":
        out = _decode_attention(q, ck, cv, pos + S - 1, window).to(x.dtype)
    else:
        out = flash_attention(q, k, v, causal=mode != "encode",
                              window=window)
    return _out_proj(params, out), new_cache


def _out_proj(params: PyTree, out: torch.Tensor) -> torch.Tensor:
    """(B,S,H,hd) x (H,hd,D) -> (B,S,D) as one matmul."""
    B, S = out.shape[:2]
    out = shard(out, ("batch", "seq", "act_heads", "head_dim"))
    wo = params["wo"].reshape(-1, params["wo"].shape[-1])
    if is_dtensor(out):
        # one (B S, H hd) product, as matmul folds a contiguous plain
        # input: a DTensor's global strides of a size-1 dim (a decode
        # step's S = 1) can read as strided and send matmul to a batched
        # product, rounding otherwise than the plain path
        y = torch.matmul(out.reshape(B * S, -1), wo).view(B, S, -1)
    else:
        y = torch.matmul(out.reshape(B, S, -1), wo)
    return shard(y, ("batch", "seq", "embed"))


def _seq_offset(c, dim: int) -> int:
    """The global index of the first row, along `dim`, of this rank's
    shard of DTensor c (the dims a DTensor shards divide evenly)."""
    mesh, off, size = c.device_mesh, 0, c.shape[dim]
    for m, p in enumerate(c.placements):
        if p.is_shard(dim):
            size //= mesh.size(m)
            off += mesh.get_local_rank(m) * size
    return off


def write_cache(c: torch.Tensor, idx: torch.Tensor,
                new: torch.Tensor, slots: list) -> None:
    """c[:, idx] = new, in place, cast to c's dtype; `slots` is idx's
    values on the host. On a DTensor cache each rank writes its own
    shard: `new` is laid out as the cache (redistributed), and a cache
    sharded over its sequence dim (the serve rules' `cache_seq`) takes
    only the positions its block holds, picked on the host (no device
    sync, and no data-dependent shape for the dry-run's fake
    tensors)."""
    new = new.to(c.dtype)
    if not is_dtensor(c):
        c.index_copy_(1, idx, new)
        return
    from torch.distributed.tensor import DTensor, Replicate
    mesh, pl = c.device_mesh, c.placements
    if not is_dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim)
    local = c.to_local()
    if not any(p.is_shard(1) for p in pl):
        local.index_copy_(1, idx, new.redistribute(mesh, pl).to_local())
        return
    rows = new.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                   for p in pl]).to_local()
    start = _seq_offset(c, 1)
    mine = [j for j, s in enumerate(slots)
            if start <= s < start + local.shape[1]]
    if mine:
        mine = torch.tensor(mine, device=idx.device)
        local.index_copy_(1, idx[mine] - start, rows[:, mine])


def init_attention_cache(cfg, batch: int, cache_len: int, window: int,
                         dtype, device, lead: tuple = ()) -> PyTree:
    k_heads, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    size = min(cache_len, window) if window else cache_len
    shape = tuple(lead) + (batch, size, k_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, cfg, device, lead: tuple = ()
             ) -> PyTree:
    dt = cdtype(cfg)
    return {
        "norm": rmsnorm_init(d, device, lead),
        "wi": dense_init(gen, (d, d_ff), d, dt, device, lead),      # gate
        "wu": dense_init(gen, (d, d_ff), d, dt, device, lead),      # up
        "wo": dense_init(gen, (d_ff, d), d_ff, dt, device, lead),   # down
    }


def mlp_apply(params: PyTree, x: torch.Tensor, cfg) -> torch.Tensor:
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    wi = shard(params["wi"], ("embed_fsdp", "mlp"))
    wu = shard(params["wu"], ("embed_fsdp", "mlp"))
    wo = shard(params["wo"], ("mlp", "embed_fsdp"))
    a = F.silu(torch.matmul(h, wi))
    b = torch.matmul(h, wu)
    return shard(torch.matmul(a * b, wo), ("batch", "seq", "embed"))
