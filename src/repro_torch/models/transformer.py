"""The transformer stack of the port, as the JAX package's
`models/transformer.py`, for the block kinds attn (full causal), swa
(sliding window), rglru (RecurrentGemma) and xLSTM's mlstm and slstm.
Attention and rglru layers take the gated-MLP channel mixer when
`d_ff` is set; the xLSTM blocks embed their own mixers and take none.

The param and cache trees are the reference's: the `block_pattern`
repeats `num_layers // P` times, so `groups` leaves carry a leading
n_rep dim, and the `L % P` remainder layers sit under `rem{r}`. A Python
loop over the groups takes the place of `lax.scan`. Caches are updated
in place and returned.

Public API:
    model = Transformer(cfg)
    params = model.init(generator, device)          # device "meta": shapes
    logits = model.forward(params, batch)           # teacher forcing
    loss = model.loss(params, batch)                # next-token CE (f32)
    cache = model.init_cache(batch_size, cache_len, device)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode_step(params, tokens, cache)

In train mode with `cfg.remat` (and a gradient wanted), each layer
group runs under `torch.utils.checkpoint` (non-reentrant): its
activations are dropped after the forward and recomputed in the
backward from the group's (B, S, D) input, the counterpart of the
reference's `jax.checkpoint(..., nothing_saveable)` around its scan
body. Attention is differentiable through the flash kernels' autograd
Function, and the RG-LRU scan through its own (the scan's backward
kernel); the xLSTM blocks are plain PyTorch, differentiated by autograd.

Not ported yet (a later slice; each raises NotImplementedError): MoE,
cross-attention and the encoder, and the `tokens+prefix`/`embeddings`
inputs.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, MLSTM, RGLRU, SLSTM, SWA,
                                      ArchConfig)
from repro_torch.models import layers, recurrent
from repro_torch.models.layers import cdtype

PyTree = Any
# where the missing features stand in ROADMAP.md's queue 1: MoE,
# cross-attention and the encoder, and the other inputs
_LATER = ("is not ported yet (a later slice of the port: ROADMAP queue 1, "
          "'MoE, then cross-attention')")
_KINDS = (ATTN, SWA, RGLRU, MLSTM, SLSTM)


def _unsupported(cfg: ArchConfig) -> list[str]:
    out = []
    if cfg.num_experts:
        out.append("MoE")
    if cfg.cross_attention or cfg.encoder_layers:
        out.append("cross-attention / the encoder")
    if cfg.input_mode != "tokens":
        out.append(f"input_mode {cfg.input_mode!r}")
    out += [f"block kind {k!r}" for k in dict.fromkeys(cfg.block_pattern)
            if k not in _KINDS]
    return out


def _takes_mlp(cfg: ArchConfig, block_kind: str) -> bool:
    """The reference's `_mixer_kind` rule: the xLSTM blocks embed their
    own mixers and take none whatever d_ff is; the other blocks take the
    gated MLP when d_ff is set (MoE, its other mixer, is not ported)."""
    return block_kind not in (MLSTM, SLSTM) and bool(cfg.d_ff)


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
            if v.data_ptr() != dst.data_ptr():     # written in place already
                dst.copy_(v)


def layer_init(gen, cfg: ArchConfig, block_kind: str, device,
               lead: tuple = ()) -> PyTree:
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
        raise NotImplementedError(f"block kind {block_kind!r} {_LATER}")
    if _takes_mlp(cfg, block_kind):
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg, device,
                                   lead)
    return p


def layer_apply(p: PyTree, x: torch.Tensor, cfg: ArchConfig,
                block_kind: str, *, mode: str, cache: Optional[PyTree]
                ) -> tuple[torch.Tensor, Optional[PyTree]]:
    """Returns (x_out, new_cache)."""
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
        raise NotImplementedError(f"block kind {block_kind!r} {_LATER}")
    x = x + y
    if "mlp" in p:
        x = x + layers.mlp_apply(p["mlp"], x, cfg)
    return x, (None if nc is None else {"temporal": nc})


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
    raise NotImplementedError(f"block kind {block_kind!r} {_LATER}")


class Transformer:
    def __init__(self, cfg: ArchConfig):
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(missing)} {_LATER}")
        self.cfg = cfg
        P = len(cfg.block_pattern)
        self.n_rep = cfg.num_layers // P
        self.n_rem = cfg.num_layers % P
        self.pattern = cfg.block_pattern

    # -- init ---------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator], device) -> PyTree:
        """Random params drawn leaf by leaf on `device` (each leaf in f32,
        then cast, so the full model never exists in f32). On the "meta"
        device this gives the shapes and dtypes only."""
        cfg = self.cfg
        params: PyTree = {
            "embed": layers.embedding_init(generator, cfg.vocab_size,
                                           cfg.d_model, cdtype(cfg), device),
            "final_norm": layers.rmsnorm_init(cfg.d_model, device),
        }
        if self.n_rep:
            params["groups"] = {
                f"b{j}": layer_init(generator, cfg, kind, device,
                                    (self.n_rep,))
                for j, kind in enumerate(self.pattern)}
        for r in range(self.n_rem):
            params[f"rem{r}"] = layer_init(generator, cfg, self.pattern[r],
                                           device)
        return params

    # -- the stack ------------------------------------------------------------
    def _group(self, group: PyTree, x: torch.Tensor, mode: str,
               cache: Optional[PyTree] = None, i: int = 0
               ) -> tuple[torch.Tensor, dict]:
        """Group i of the stacked layers, its params unstacked. With a
        cache, each layer reads its slice i of the stacked group cache
        and writes its new cache back there; returns x and the layers'
        new caches (None without a cache)."""
        new = {}
        for j, kind in enumerate(self.pattern):
            lc = None if cache is None else _index(
                cache["groups"][f"b{j}"], i)
            x, new[j] = layer_apply(group[f"b{j}"], x, self.cfg, kind,
                                    mode=mode, cache=lc)
            if cache is not None:
                _write_back(cache["groups"][f"b{j}"], i, new[j])
        return x, new

    def _run(self, params: PyTree, x: torch.Tensor, cache: Optional[PyTree],
             mode: str) -> torch.Tensor:
        cfg = self.cfg
        remat = (cache is None and mode == "train" and cfg.remat
                 and torch.is_grad_enabled())
        last = {}
        groups = _unstack(params["groups"], self.n_rep) if self.n_rep else []
        for i, group in enumerate(groups):
            if remat:
                # no random ops inside: no RNG state to stash
                x = checkpoint(self._group, group, x, mode,
                               use_reentrant=False,
                               preserve_rng_state=False)[0]
            else:
                x, last = self._group(group, x, mode, cache, i)
        if cache is not None:
            for j, nc in last.items():
                _write_back(cache["groups"][f"b{j}"], 0, nc, tensors=False)
        for r in range(self.n_rem):
            lc = None if cache is None else cache[f"rem{r}"]
            x, nc = layer_apply(params[f"rem{r}"], x, cfg, self.pattern[r],
                                mode=mode, cache=lc)
            if cache is not None:
                cache[f"rem{r}"] = nc
        return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)

    def _tokens(self, batch: dict) -> torch.Tensor:
        if "tokens" not in batch:
            raise NotImplementedError(f"inputs other than tokens {_LATER}")
        return batch["tokens"]

    # -- full-sequence forward (teacher forcing) ------------------------------
    def forward(self, params: PyTree, batch: dict) -> torch.Tensor:
        """Logits (B, S, V) in the config dtype. (The reference also
        returns the MoE aux loss; with no MoE here there is none.)"""
        x = layers.embed(params["embed"], self._tokens(batch))
        x = self._run(params, x, None, "train")
        return layers.unembed(params["embed"], x)

    # -- loss ------------------------------------------------------------------
    def loss(self, params: PyTree, batch: dict) -> torch.Tensor:
        """Next-token cross-entropy in f32, the mean over the unmasked
        targets. batch["labels"]: (B, S) with labels < 0 masked; the
        logits at position t are scored against labels[t + 1]. (The
        reference adds the MoE aux loss; with no MoE here it is 0.)"""
        logits = self.forward(params, batch)[:, :-1]
        targets = batch["labels"][:, 1:]
        mask = targets >= 0
        lp = F.log_softmax(logits.to(torch.float32), dim=-1)
        del logits
        ll = lp.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
        return -(ll * mask).sum() / mask.sum().clamp_min(1)

    # -- caches -----------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, device) -> PyTree:
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
        return cache

    # -- prefill / decode --------------------------------------------------------
    def prefill(self, params: PyTree, batch: dict, cache: PyTree
                ) -> tuple[torch.Tensor, PyTree]:
        """Run the prompt through the model, filling the cache. Returns
        (last-position logits (B, 1, V), cache)."""
        x = layers.embed(params["embed"], self._tokens(batch))
        x = self._run(params, x, cache, "prefill")
        return layers.unembed(params["embed"], x[:, -1:]), cache

    def decode_step(self, params: PyTree, tokens: torch.Tensor,
                    cache: PyTree) -> tuple[torch.Tensor, PyTree]:
        """tokens: (B, 1). Returns (logits (B, 1, V), cache)."""
        x = layers.embed(params["embed"], tokens)
        x = self._run(params, x, cache, "decode")
        return layers.unembed(params["embed"], x), cache
