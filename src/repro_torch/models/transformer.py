"""The transformer stack of the port, as the JAX package's
`models/transformer.py`, for the block kinds attn (full causal), swa
(sliding window) and rglru (RecurrentGemma) with the gated-MLP mixer.

The param and cache trees are the reference's: the `block_pattern`
repeats `num_layers // P` times, so `groups` leaves carry a leading
n_rep dim, and the `L % P` remainder layers sit under `rem{r}`. A Python
loop over the groups takes the place of `lax.scan`. Caches are updated
in place and returned.

Public API:
    model = Transformer(cfg)
    params = model.init(generator, device)          # device "meta": shapes
    logits = model.forward(params, batch)           # teacher forcing
    cache = model.init_cache(batch_size, cache_len, device)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode_step(params, tokens, cache)

Not ported yet (a later slice; each raises NotImplementedError): MoE,
cross-attention and the encoder, `tokens+prefix`/`embeddings` inputs,
and the mLSTM and sLSTM blocks. `loss`, and any backward through the
kernels, come with the training slice.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ATTN, RGLRU, SWA, ArchConfig
from repro_torch.models import layers, recurrent
from repro_torch.models.layers import cdtype

PyTree = Any
_LATER = "is not ported yet (a later slice of the port, ROADMAP queue 1 #13)"


def _unsupported(cfg: ArchConfig) -> list[str]:
    out = []
    if cfg.num_experts:
        out.append("MoE")
    if cfg.cross_attention or cfg.encoder_layers:
        out.append("cross-attention / the encoder")
    if cfg.input_mode != "tokens":
        out.append(f"input_mode {cfg.input_mode!r}")
    out += [f"block kind {k!r}" for k in dict.fromkeys(cfg.block_pattern)
            if k not in (ATTN, SWA, RGLRU)]
    return out


def _index(tree: PyTree, i: int) -> PyTree:
    """Layer i of a stacked group tree (views; ints pass through)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i] if torch.is_tensor(tree) else tree


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
    else:
        raise NotImplementedError(f"block kind {block_kind!r} {_LATER}")
    if cfg.d_ff:
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
    def _run(self, params: PyTree, x: torch.Tensor, cache: Optional[PyTree],
             mode: str) -> torch.Tensor:
        cfg = self.cfg
        last = {}
        for i in range(self.n_rep):
            for j, kind in enumerate(self.pattern):
                lp = _index(params["groups"][f"b{j}"], i)
                lc = None if cache is None else _index(
                    cache["groups"][f"b{j}"], i)
                x, nc = layer_apply(lp, x, cfg, kind, mode=mode, cache=lc)
                if cache is not None:
                    _write_back(cache["groups"][f"b{j}"], i, nc)
                    last[j] = nc
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
