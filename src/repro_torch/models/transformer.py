"""The transformer stack of the port, as the JAX package's
`models/transformer.py`, for every config of the repo: the block kinds
attn (full causal), swa (sliding window), rglru (RecurrentGemma) and
xLSTM's mlstm and slstm; a channel mixer per attention or rglru layer,
the gated MLP or, with `num_experts`, MoE (`models/moe.py`, Arctic's
dense residual included); the xLSTM blocks embed their own mixers and
take none. Optional per config: an encoder stack and cross-attention in
every decoder layer (SeamlessM4T), and inputs of prefix embeddings
before the tokens (LLaVA) or of embeddings alone.

The param and cache trees are the reference's: the `block_pattern`
repeats `num_layers // P` times, so `groups` leaves carry a leading
n_rep dim, and the `L % P` remainder layers sit under `rem{r}`; the
encoder's layers are stacked under `encoder/layers`. A Python loop over
the groups takes the place of `lax.scan`. Caches are updated in place
and returned.

Public API:
    model = Transformer(cfg)
    params = model.init(generator, device)          # device "meta": shapes
    logits, aux = model.forward(params, batch)      # teacher forcing
    loss = model.loss(params, batch)                # CE (f32) + 0.01 aux
    memory = model.encode(params, frames)           # encoder-decoder
    cache = model.init_cache(batch_size, cache_len, device, memory=memory,
                             params=params)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode_step(params, tokens, cache)

batch: "tokens" (B, S); "prefix" (B, prefix_len, D) before them for
input_mode "tokens+prefix"; "embeddings" (B, S, D) in place of them for
"embeddings"; "frames" (B, M, D) for a config with an encoder (forward
and loss; serving encodes them into the cache); "labels" for the loss.

In train mode with `cfg.remat` (and a gradient wanted), each layer
group, and each encoder layer, runs under `torch.utils.checkpoint`
(non-reentrant): its activations are dropped after the forward and
recomputed in the backward from its (B, S, D) input, the counterpart
of the reference's `jax.checkpoint(..., nothing_saveable)` around its
scan body. Attention is differentiable through the flash kernels'
autograd Function, and the RG-LRU scan through its own (the scan's
backward kernel); MoE's dispatch and the xLSTM blocks are plain
PyTorch, differentiated by autograd.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, MLSTM, RGLRU, SLSTM, SWA,
                                      ArchConfig)
from repro_torch.models import layers, moe, recurrent
from repro_torch.models.layers import cdtype
from repro_torch.sharding.rules import is_dtensor, shard

PyTree = Any
F32 = torch.float32


def _mixer_kind(cfg: ArchConfig, block_kind: str) -> str:
    """The xLSTM blocks embed their own mixers and take none; the other
    blocks take MoE with `num_experts`, else the gated MLP when d_ff is
    set."""
    if block_kind in (MLSTM, SLSTM):
        return "none"
    if cfg.num_experts:
        return "moe"
    return "mlp" if cfg.d_ff else "none"


def _add(total: Optional[torch.Tensor], a: Optional[torch.Tensor]
         ) -> Optional[torch.Tensor]:
    """Sum of aux losses, None standing for a layer without MoE."""
    if a is None:
        return total
    return a if total is None else total + a


def _index(tree: PyTree, i: int) -> PyTree:
    """Layer i of a stacked group tree (views; ints pass through)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i] if torch.is_tensor(tree) else tree


def _unstack(tree: PyTree, n: int) -> list[PyTree]:
    """The n layers of a stacked group tree, as n trees of views. One
    `unbind` per leaf, so that autograd stacks the n layer gradients of
    a leaf once, where indexing layer by layer would fill and add a
    full-size gradient per layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if is_dtensor(tree) and any(p.is_shard(0) for p in tree.placements):
        # a layer-stack dim a rule shards (the table's attention "wo"
        # rule also matches RG-LRU's wo): gathered, as a scan over it is
        from torch.distributed.tensor import Replicate
        tree = tree.redistribute(tree.device_mesh, [
            Replicate() if p.is_shard(0) else p for p in tree.placements])
    return list(torch.unbind(tree, 0))


def _write_back(stacked: PyTree, i: int, new: PyTree,
                tensors: bool = True) -> None:
    """Store layer i's new cache tensors into the stacked group cache
    (tensors=True), or its ints, the same `pos` for every layer of the
    group (tensors=False, once all layers have read the old one)."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write_back(stacked[k], i, v, tensors)
        elif not torch.is_tensor(v):
            if not tensors:
                stacked[k] = v
        elif tensors:
            dst = stacked[k][i]
            if _ptr(v) != _ptr(dst):               # written in place already
                dst.copy_(v)


def _ptr(x: torch.Tensor) -> int:
    """The data pointer of x (of a DTensor: of this rank's shard)."""
    return (x.to_local() if is_dtensor(x) else x).data_ptr()


def layer_init(gen, cfg: ArchConfig, block_kind: str, device,
               lead: tuple = (), cross: bool = False) -> PyTree:
    p: PyTree = {}
    if block_kind in (ATTN, SWA):
        p["temporal"] = layers.attention_init(gen, cfg, device, lead)
    elif block_kind == RGLRU:
        p["temporal"] = recurrent.rglru_init(gen, cfg, device, lead)
    elif block_kind == MLSTM:
        p["temporal"] = recurrent.mlstm_init(gen, cfg, device, lead)
    elif block_kind == SLSTM:
        p["temporal"] = recurrent.slstm_init(gen, cfg, device, lead)
    else:
        raise ValueError(f"block kind {block_kind!r}")
    if cross:
        p["cross"] = layers.attention_init(gen, cfg, device, lead)
    mk = _mixer_kind(cfg, block_kind)
    if mk == "mlp":
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg, device,
                                   lead)
    elif mk == "moe":
        p["moe"] = moe.moe_init(gen, cfg, device, lead)
    return p


def layer_apply(p: PyTree, x: torch.Tensor, cfg: ArchConfig,
                block_kind: str, *, mode: str, cache: Optional[PyTree],
                memory_kv: Optional[tuple] = None
                ) -> tuple[torch.Tensor, Optional[PyTree],
                           Optional[torch.Tensor]]:
    """Returns (x_out, new_cache, aux): aux is the MoE load-balance loss
    (an f32 scalar), None for a layer without MoE."""
    # a sequence-parallel residual (the rules' residual_seq between layer
    # groups) is gathered where the layer's products need whole rows, as
    # the reference's partitioner gathers it
    x = shard(x, ("batch", "seq", "embed"))
    tcache = None if cache is None else cache.get("temporal")
    if block_kind in (ATTN, SWA):
        window = cfg.window_size if block_kind == SWA else 0
        y, nc = layers.attention_apply(p["temporal"], x, cfg, mode=mode,
                                       layer_cache=tcache, window=window)
    elif block_kind == RGLRU:
        y, nc = recurrent.rglru_apply(p["temporal"], x, cfg, mode=mode,
                                      layer_cache=tcache)
    elif block_kind == MLSTM:
        y, nc = recurrent.mlstm_block_apply(p["temporal"], x, cfg,
                                            mode=mode, layer_cache=tcache)
    elif block_kind == SLSTM:
        y, nc = recurrent.slstm_apply(p["temporal"], x, cfg, mode=mode,
                                      layer_cache=tcache)
    else:
        raise ValueError(f"block kind {block_kind!r}")
    x = x + y
    if "cross" in p and memory_kv is not None:
        y, _ = layers.attention_apply(p["cross"], x, cfg, mode=mode,
                                      memory_kv=memory_kv)
        x = x + y
    aux = None
    if "mlp" in p:
        x = x + layers.mlp_apply(p["mlp"], x, cfg)
    elif "moe" in p:
        y, aux = moe.moe_apply(p["moe"], x, cfg)
        x = x + y
    return x, (None if nc is None else {"temporal": nc}), aux


def init_layer_cache(cfg: ArchConfig, block_kind: str, batch: int,
                     cache_len: int, dtype, device, lead: tuple = ()
                     ) -> PyTree:
    if block_kind in (ATTN, SWA):
        window = cfg.window_size if block_kind == SWA else 0
        return {"temporal": layers.init_attention_cache(
            cfg, batch, cache_len, window, dtype, device, lead)}
    if block_kind == RGLRU:
        return {"temporal": recurrent.init_rglru_cache(cfg, batch, dtype,
                                                       device, lead)}
    if block_kind == MLSTM:
        return {"temporal": recurrent.init_mlstm_cache(cfg, batch, device,
                                                       lead)}
    if block_kind == SLSTM:
        return {"temporal": recurrent.init_slstm_cache(cfg, batch, device,
                                                       lead)}
    raise ValueError(f"block kind {block_kind!r}")


class Transformer:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        P = len(cfg.block_pattern)
        self.n_rep = cfg.num_layers // P
        self.n_rem = cfg.num_layers % P
        self.pattern = cfg.block_pattern

    # -- init ---------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator], device) -> PyTree:
        """Random params drawn leaf by leaf on `device`, by
        `layers.normal_init`'s rule (in f32 a block of rows at a time,
        then cast, so no large leaf ever exists in f32). On the "meta"
        device this gives the shapes and dtypes only."""
        cfg = self.cfg
        cross = cfg.cross_attention
        params: PyTree = {
            "embed": layers.embedding_init(generator, cfg.vocab_size,
                                           cfg.d_model, cdtype(cfg), device),
            "final_norm": layers.rmsnorm_init(cfg.d_model, device),
        }
        if self.n_rep:
            params["groups"] = {
                f"b{j}": layer_init(generator, cfg, kind, device,
                                    (self.n_rep,), cross)
                for j, kind in enumerate(self.pattern)}
        for r in range(self.n_rem):
            params[f"rem{r}"] = layer_init(generator, cfg, self.pattern[r],
                                           device, (), cross)
        if cfg.encoder_layers:
            params["encoder"] = {
                "layers": layer_init(generator, cfg, ATTN, device,
                                     (cfg.encoder_layers,)),
                "final_norm": layers.rmsnorm_init(cfg.d_model, device),
            }
        return params

    # -- inputs and the encoder -------------------------------------------------
    def _embed_inputs(self, params: PyTree, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        if cfg.input_mode == "embeddings":
            return batch["embeddings"].to(cdtype(cfg))
        x = layers.embed(params["embed"], batch["tokens"])
        if cfg.input_mode == "tokens+prefix":
            prefix = shard(batch["prefix"].to(x.dtype),
                           ("batch", "seq", "embed"))
            x = torch.cat([prefix, x], dim=1)
        return shard(x, ("batch", "seq", "embed"))

    def _encoder_layer(self, lp: PyTree, x: torch.Tensor) -> torch.Tensor:
        return layer_apply(lp, x, self.cfg, ATTN, mode="encode",
                           cache=None)[0]

    def encode(self, params: PyTree, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, M, D) precomputed frontend embeddings -> the
        memory (B, M, D): the encoder's bidirectional layers, then its
        final norm. Each layer under remat when a gradient is wanted."""
        cfg = self.cfg
        x = frames.to(cdtype(cfg))
        remat = cfg.remat and torch.is_grad_enabled()
        for lp in _unstack(params["encoder"]["layers"], cfg.encoder_layers):
            if remat:
                x = checkpoint(self._encoder_layer, lp, x,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = self._encoder_layer(lp, x)
        return layers.rmsnorm(params["encoder"]["final_norm"], x,
                              cfg.norm_eps)

    def _memory_kv(self, params_attn: PyTree, memory: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """A cross block's K and V of the memory, each (B, M, K, hd)."""
        h = layers.rmsnorm(params_attn["norm"], memory, self.cfg.norm_eps)
        return (layers.project(h, params_attn["wk"]),
                layers.project(h, params_attn["wv"]))

    def _cross(self, lp: PyTree, memory: Optional[torch.Tensor],
               stored: Optional[torch.Tensor]) -> Optional[tuple]:
        """A layer's memory K/V: from the memory (forward), or its slice
        (2, B, M, K, hd) of the cache's precomputed `cross_kv` (serving);
        None for a layer without cross-attention."""
        if "cross" not in lp:
            return None
        if memory is not None:
            return self._memory_kv(lp["cross"], memory)
        return None if stored is None else (stored[0], stored[1])

    # -- the stack ------------------------------------------------------------
    def _group(self, group: PyTree, x: torch.Tensor, mode: str,
               cache: Optional[PyTree] = None, i: int = 0,
               memory: Optional[torch.Tensor] = None):
        """Group i of the stacked layers, its params unstacked. With a
        cache, each layer reads its slice i of the stacked group cache
        (and of `cross_kv`) and writes its new cache back there; returns
        x, the layers' new caches (None without a cache) and the group's
        aux loss (None without MoE)."""
        new, aux = {}, None
        for j, kind in enumerate(self.pattern):
            lc = stored = None
            if cache is not None:
                lc = _index(cache["groups"][f"b{j}"], i)
                if "cross_kv" in cache:
                    stored = cache["cross_kv"][f"b{j}"][i]
            lp = group[f"b{j}"]
            x, new[j], a = layer_apply(lp, x, self.cfg, kind, mode=mode,
                                       cache=lc, memory_kv=self._cross(
                                           lp, memory, stored))
            aux = _add(aux, a)
            if cache is not None:
                _write_back(cache["groups"][f"b{j}"], i, new[j])
        return x, new, aux

    def _run(self, params: PyTree, x: torch.Tensor, cache: Optional[PyTree],
             mode: str, memory: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The decoder stack and the final norm; returns (x, aux)."""
        cfg = self.cfg
        remat = (cache is None and mode == "train" and cfg.remat
                 and torch.is_grad_enabled())
        last, aux = {}, None
        groups = _unstack(params["groups"], self.n_rep) if self.n_rep else []
        for i, group in enumerate(groups):
            if remat:
                # no random ops inside: no RNG state to stash
                x, _, a = checkpoint(self._group, group, x, mode, None, i,
                                     memory, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                x, last, a = self._group(group, x, mode, cache, i, memory)
            if cache is None:
                # the sequence-parallel residual boundary (the rules map
                # residual_seq to "model" in training)
                x = shard(x, ("batch", "residual_seq", "embed"))
            aux = _add(aux, a)
        if cache is not None:
            for j, nc in last.items():
                _write_back(cache["groups"][f"b{j}"], 0, nc, tensors=False)
        for r in range(self.n_rem):
            lc = None if cache is None else cache[f"rem{r}"]
            stored = None if cache is None else cache.get(f"cross_kv_rem{r}")
            lp = params[f"rem{r}"]
            x, nc, a = layer_apply(lp, x, cfg, self.pattern[r], mode=mode,
                                   cache=lc, memory_kv=self._cross(
                                       lp, memory, stored))
            aux = _add(aux, a)
            if cache is not None:
                cache[f"rem{r}"] = nc
        x = shard(x, ("batch", "seq", "embed"))
        return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux

    # -- full-sequence forward (teacher forcing) ------------------------------
    def forward(self, params: PyTree, batch: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, S, V) in the config dtype, the summed MoE aux
        loss, an f32 scalar, 0 without MoE). With a prefix, S counts the
        prefix positions too."""
        x = self._embed_inputs(params, batch)
        memory = (self.encode(params, batch["frames"])
                  if self.cfg.encoder_layers else None)
        x, aux = self._run(params, x, None, "train", memory)
        if aux is None:
            aux = torch.zeros((), dtype=F32, device=x.device)
        return layers.unembed(params["embed"], x), aux

    # -- loss ------------------------------------------------------------------
    def loss(self, params: PyTree, batch: dict,
             aux_weight: float = 0.01) -> torch.Tensor:
        """Next-token cross-entropy in f32, the mean over the unmasked
        targets, plus `aux_weight` times the MoE aux loss. batch["labels"]:
        (B, S) with labels < 0 masked; the logits at token position t are
        scored against labels[t + 1] (the prefix's logits are dropped)."""
        logits, aux = self.forward(params, batch)
        if self.cfg.input_mode == "tokens+prefix":
            logits = logits[:, self.cfg.prefix_len:]
        logits = logits[:, :-1]
        targets = batch["labels"][:, 1:].long()
        mask = targets >= 0
        lp = F.log_softmax(logits.to(torch.float32), dim=-1)
        del logits
        ll = lp.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
        ce = -(ll * mask).sum() / mask.sum().clamp_min(1)
        return ce + aux_weight * aux

    # -- caches -----------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, device,
                   memory: Optional[torch.Tensor] = None,
                   params: Optional[PyTree] = None) -> PyTree:
        """Zeroed self-attention/recurrent caches; with cross-attention,
        a `memory` and the `params`, also each decoder layer's memory K/V
        stacked as (2, B, M, K, hd): `cross_kv` {"b{j}": (n_rep, 2, ...)}
        and `cross_kv_rem{r}`, as the reference keys them."""
        cfg = self.cfg
        dt = cdtype(cfg)
        cache: PyTree = {}
        if self.n_rep:
            cache["groups"] = {
                f"b{j}": init_layer_cache(cfg, kind, batch, cache_len, dt,
                                          device, (self.n_rep,))
                for j, kind in enumerate(self.pattern)}
        for r in range(self.n_rem):
            cache[f"rem{r}"] = init_layer_cache(cfg, self.pattern[r], batch,
                                                cache_len, dt, device)
        if cfg.cross_attention and memory is not None and params is not None:
            if self.n_rep:
                cache["cross_kv"] = {}
                for j in range(len(self.pattern)):
                    gp = params["groups"][f"b{j}"]["cross"]
                    kv = None
                    for i, lp in enumerate(_unstack(gp, self.n_rep)):
                        k, v = self._memory_kv(lp, memory)
                        if kv is None:
                            kv = k.new_empty((self.n_rep, 2) + k.shape)
                        kv[i, 0], kv[i, 1] = k, v
                    cache["cross_kv"][f"b{j}"] = kv
            for r in range(self.n_rem):
                cache[f"cross_kv_rem{r}"] = torch.stack(self._memory_kv(
                    params[f"rem{r}"]["cross"], memory))
        return cache

    # -- prefill / decode --------------------------------------------------------
    def prefill(self, params: PyTree, batch: dict, cache: PyTree
                ) -> tuple[torch.Tensor, PyTree]:
        """Run the prompt (after its prefix, if any) through the model,
        filling the cache. Returns (last-position logits (B, 1, V),
        cache)."""
        x = self._embed_inputs(params, batch)
        x, _ = self._run(params, x, cache, "prefill")
        return layers.unembed(params["embed"], x[:, -1:]), cache

    def decode_step(self, params: PyTree, tokens: torch.Tensor,
                    cache: PyTree) -> tuple[torch.Tensor, PyTree]:
        """tokens: (B, 1). Returns (logits (B, 1, V), cache)."""
        x = shard(layers.embed(params["embed"], tokens),
                  ("batch", "seq", "embed"))
        x, _ = self._run(params, x, cache, "decode")
        return layers.unembed(params["embed"], x), cache
