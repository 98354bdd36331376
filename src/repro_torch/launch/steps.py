"""Builds the (train / prefill / decode) step for an (architecture x
input-shape x mesh) combination with every input and state leaf placed
on a torch DeviceMesh (the JAX package's `launch/steps.py`).

This is the single place where the mapping decisions live:
  * the swarm layout per arch (`cfg.swarm_mode`: "tp" shards the W
    spatial workers over "data", "fsdp" runs one worker over the whole
    pod),
  * the sharding rules per mode (`train_rules`, `serve_rules`),
  * `input_specs()`: meta-device stand-ins for every model input (the
    reference's `ShapeDtypeStruct`s, the same shapes and dtypes).

A `BuiltStep` carries `fn`, its meta-device `args` and each arg leaf's
`Layout` (spec and DTensor placements, `layouts`). `fn` runs under
`use_rules(rules, mesh)` on real tensors placed as `layouts` say:
`place` makes DTensors whose shards are views of given whole tensors
(no second copy on one rank); `init_placed` draws a model's params shard
by shard and `init_state_placed` builds the swarm state from them, so
that across ranks no rank holds a whole leaf its layout shards. The train step's `fn(state, batch,
eval_batch, draws)` takes the round's `RoundDraws` where the
reference's takes a key (every random draw of the port is an input); its
meta `args` carry a `RoundDraws` of meta tensors. Returned tensors are
DTensors (`full_tensor()` for the whole value).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.comm.budget import CommConfig
from repro_torch.comm.phy import PhyState
from repro_torch.comm.straggler import StragglerBuffer
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import population as pop
from repro_torch.core import swarm_dist
from repro_torch.core.mdsl import RoundDraws
from repro_torch.core.swarm_dist import DistSwarmConfig, DistSwarmState
from repro_torch.models.transformer import Transformer
from repro_torch.pytree import tree_flatten, tree_leaves, \
    tree_leaves_with_path, tree_map, tree_unflatten
from repro_torch.sharding import rules as rules_mod
from repro_torch.sharding.param_specs import Layout, tree_shardings
from repro_torch.sharding.rules import (ShardingRules, axes_size, axis_names,
                                        axis_size, norm_entry, placements,
                                        use_rules)

PyTree = Any

EVAL_BATCH = 4          # D_g scoring batch (selection), per worker


def _prep_cfg(cfg: ArchConfig) -> ArchConfig:
    """Mesh-run config tweaks: pad vocab to a 16-multiple (seamless)."""
    if cfg.vocab_size % 16:
        cfg = dataclasses.replace(cfg, vocab_size=cfg.padded_vocab(16))
    return cfg


def swarm_layout(cfg: ArchConfig, mesh) -> tuple[tuple[str, ...], int]:
    """(worker_axes, num_spatial_workers)."""
    multi = "pod" in axis_names(mesh)
    if cfg.swarm_mode == "tp":
        axes = ("pod", "data") if multi else ("data",)
    else:  # fsdp
        axes = ("pod",) if multi else ()
    W = 1
    for a in axes:
        W *= axis_size(mesh, a)
    return axes, W


def train_rules(cfg: ArchConfig, mesh) -> ShardingRules:
    multi = "pod" in axis_names(mesh)
    if cfg.swarm_mode == "tp":
        return rules_mod.MULTI_POD_TP if multi else rules_mod.SINGLE_POD_TP
    return (rules_mod.MULTI_POD_FSDP_TP if multi
            else rules_mod.SINGLE_POD_FSDP_TP)


def serve_rules(cfg: ArchConfig, mesh, long_context: bool) -> ShardingRules:
    multi = "pod" in axis_names(mesh)
    batch_axes = ("pod", "data") if multi else ("data",)
    # KV-cache head sharding only works when kv_heads divides the model
    # axis; otherwise shard the cache SEQUENCE over "model" instead
    # (flash-decode style), so that an arch with 8 kv heads on a 16-way
    # model axis does not replicate its cache on every card
    kv_shardable = cfg.num_kv_heads % axis_size(mesh, "model") == 0
    r = ShardingRules(
        batch=None, seq=None,
        embed=None,
        # big archs keep FSDP-sharded weights at serving too (memory),
        # small archs are pure-TP (no per-layer all-gathers)
        embed_fsdp="data" if cfg.swarm_mode == "fsdp" else None,
        heads="model", kv_heads="model", q_per_kv=None, head_dim=None,
        # activation heads follow the weights only when the cache stays
        # head-sharded; with a seq-sharded cache the act heads replicate
        act_heads="model" if kv_shardable else None,
        act_kv_heads="model" if kv_shardable else None,
        residual_seq=None,
        mlp="model", vocab="model",
        expert="data" if cfg.num_experts >= 64 else "model",
        expert_mlp="model" if cfg.num_experts >= 64 else None,
        worker=None,
        cache_batch=batch_axes,
        cache_seq=None if kv_shardable else "model",
        # the all-to-all EP dispatch at serving too
        moe_ep=cfg.num_experts >= 64,
    )
    if long_context:
        # batch=1: context-parallel KV cache over the data axis
        r = ShardingRules(r, cache_batch=None, cache_seq="data")
        r["batch"] = None
    else:
        r["batch"] = batch_axes
    return r


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch_specs(cfg: ArchConfig, batch: int, seq: int,
                       lead: tuple[int, ...] = ()) -> dict:
    """Meta tensors of one model batch (tokens + labels + frontends)."""
    i32 = torch.int32
    out = {"tokens": _meta(lead + (batch, seq), i32),
           "labels": _meta(lead + (batch, seq), i32)}
    dt = getattr(torch, cfg.dtype)
    if cfg.input_mode == "tokens+prefix":
        out["prefix"] = _meta(lead + (batch, cfg.prefix_len, cfg.d_model), dt)
    if cfg.encoder_layers:
        out["frames"] = _meta(lead + (batch, cfg.encoder_memory_len,
                                      cfg.d_model), dt)
    return out


def input_specs(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    """Meta-device stand-ins for every input of the step (no device
    allocation)."""
    cfg = _prep_cfg(cfg)
    if shape.kind == "train":
        axes, W = swarm_layout(cfg, mesh)
        per_worker = shape.global_batch // max(W, 1)
        return {
            "batch": _token_batch_specs(cfg, per_worker, shape.seq_len,
                                        lead=(W,)),
            "eval_batch": _token_batch_specs(cfg, EVAL_BATCH, shape.seq_len),
            "key": _meta((2,), torch.uint32),
        }
    if shape.kind == "prefill":
        return {"batch": _token_batch_specs(cfg, shape.global_batch,
                                            shape.seq_len)}
    # decode: one new token against a cache of seq_len
    return {"tokens": _meta((shape.global_batch, 1), torch.int32)}


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

class BuiltStep(NamedTuple):
    fn: Any                  # the step
    args: tuple              # meta-device args matching fn's signature
    rules: ShardingRules
    cfg: ArchConfig
    meta: dict
    layouts: tuple = ()      # a Layout per tensor leaf of args


def _layout(mesh, spec: tuple) -> Layout:
    return Layout(tuple(spec), placements(spec, mesh))


def _shard_batch_specs(batch: dict, rules: ShardingRules, mesh,
                       worker_axes: Optional[tuple] = None) -> dict:
    """Layouts of a token batch dict (optionally worker-stacked): the
    batch dim over rules["batch"], a mesh axis dropped where it does not
    divide."""
    def leaf(x):
        if worker_axes is not None:
            wspec = worker_axes if len(worker_axes) != 1 else worker_axes[0]
            spec = ((wspec if worker_axes else None), rules.get("batch")) + (
                None,) * (x.ndim - 2)
        else:
            spec = (rules.get("batch"),) + (None,) * (x.ndim - 1)
        fixed = tuple(None if ax is None or dim % axes_size(mesh, ax)
                      else norm_entry(ax) for dim, ax in zip(x.shape, spec))
        return _layout(mesh, fixed)

    return {k: leaf(v) for k, v in batch.items()}


def place(tree: PyTree, layouts: PyTree, mesh) -> PyTree:
    """The tensors of `tree` (the whole values, the same on every rank)
    as DTensors laid out as `layouts`: each rank's shard a view of its
    slice (made contiguous where a shard is a strided slice), so one
    rank copies nothing. Leaves that are no tensor (a cache's int `pos`,
    the state's round index) pass through."""
    from torch.distributed.tensor import DTensor
    leaves, treedef = tree_flatten(tree)
    lays = tree_leaves(layouts)
    out = []
    for x, lay in zip(leaves, lays):
        if not torch.is_tensor(x):
            out.append(x)
            continue
        local = x
        for d, p in enumerate(lay.placements):
            if p.is_shard():
                local = local.chunk(mesh.size(d), dim=p.dim)[
                    mesh.get_local_rank(d)].contiguous()
        out.append(DTensor.from_local(local, mesh, lay.placements,
                                      run_check=False))
    return tree_unflatten(treedef, out)


def _insertion_leaves(tree: PyTree, path: tuple = ()) -> list:
    """[(path, leaf)] in the dicts' insertion order: the order an init
    function builds them, which is the order it draws them."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _insertion_leaves(v, path + (str(k),))]
    return [(path, tree)]


def _box(shape: tuple, placements: tuple, mesh) -> tuple:
    """This rank's slice of a leaf laid out by `placements`: (start,
    stop) a dim (the sharded dims divide evenly)."""
    box = [[0, n] for n in shape]
    for m, p in enumerate(placements):
        if p.is_shard():
            b, e = box[p.dim]
            size = (e - b) // mesh.size(m)
            box[p.dim] = [b + mesh.get_local_rank(m) * size,
                          b + (mesh.get_local_rank(m) + 1) * size]
    return tuple(tuple(x) for x in box)


def init_placed(model: Transformer, gen: Optional[torch.Generator],
                layouts: PyTree, mesh, device) -> PyTree:
    """`model.init(gen, device)`'s params as DTensors laid out as
    `layouts`, with no rank holding a whole leaf that its layout shards:
    each leaf `layers.normal_init` draws is drawn block by block as the
    whole draw is, each rank keeping only its slice (so the values are
    the whole draw's, bit for bit); the leaves drawn otherwise (norms,
    biases, RG-LRU's lambda: one vector a layer) are made whole and
    sliced.

    A first init on "meta" records the draws' order and shapes, and maps
    each leaf to its draw: by identity, or, for a leaf computed from a
    draw (RG-LRU's conv, scaled), by shape from the one draw between its
    neighbours' in the dicts' order."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import layers

    shapes, drawn = [], []

    def record(gen, shape, scale, dtype, device):
        t = torch.empty(tuple(shape), dtype=dtype, device="meta")
        shapes.append(tuple(shape))
        drawn.append(t)             # alive, so that ids stay unique
        return t

    with layers.draw_hook(record):
        meta = model.init(None, "meta")
    index = {id(t): k for k, t in enumerate(drawn)}
    leaves = _insertion_leaves(meta)
    tagged = [index.get(id(x)) for _, x in leaves]
    draw_of, nxt = {}, 0
    for j, ((path, x), k) in enumerate(zip(leaves, tagged)):
        if k is None:
            later = [t for t in tagged[j + 1:] if t is not None]
            window = range(nxt, later[0] if later else len(shapes))
            if len(window) == 1 and shapes[window[0]] == tuple(x.shape):
                k = window[0]
        if k is not None:
            draw_of[path] = k
            nxt = k + 1
    lays = {p: lay for p, lay in tree_leaves_with_path(layouts)}
    boxes = {draw_of[p]: _box(shapes[draw_of[p]], lays[p].placements, mesh)
             for p in draw_of}
    count = iter(range(len(shapes)))

    def draw(gen, shape, scale, dtype, device):
        return layers.normal_shard(gen, shape, scale, dtype, device,
                                   boxes[next(count)])

    with layers.draw_hook(draw):
        params = model.init(gen, device)
    out = {}
    for path, x in tree_leaves_with_path(params):
        pl = lays[path].placements
        if path in draw_of:
            out[path] = DTensor.from_local(x, mesh, pl, run_check=False)
        else:
            out[path] = place(x, lays[path], mesh)
    _, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [out[p] for p, _ in
                                    tree_leaves_with_path(params)])


def init_state_placed(global_params: PyTree, dcfg: DistSwarmConfig,
                      layouts: DistSwarmState, mesh) -> DistSwarmState:
    """`swarm_dist.init_state` of DTensor global params (`init_placed`'s,
    laid out as `layouts.global_params`), laid out as `layouts`, with
    every model-sized leaf built from this rank's shards: a stacked leaf
    holds this rank's workers' rows (copies of its global shard, or
    zeros), never the whole stack; the (W,) vectors and scalars (W
    numbers each) are made whole and sliced. Leaf for leaf the state
    `init_state` makes from the whole params."""
    from torch.distributed.tensor import DTensor
    shapes = swarm_dist.init_state(tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        global_params), dcfg)
    dev = tree_leaves(global_params)[0].to_local().device
    small = swarm_dist.init_state({"x": torch.zeros(1, device=dev)}, dcfg)

    def build(like, lay, src=None):
        box = _box(tuple(like.shape), lay.placements, mesh)
        shape = tuple(e - b for b, e in box)
        if src is None:
            local = torch.zeros(shape, dtype=like.dtype, device=dev)
        else:
            s = src.to_local()
            if tuple(s.shape) != shape[1:]:
                raise ValueError(f"the stacked layout {lay.spec} shards the "
                                 f"model dims unlike the global one")
            local = s.expand(shape).clone()
        return DTensor.from_local(local, mesh, lay.placements,
                                  run_check=False)

    zeros = lambda t, lays: tree_map(build, t, lays)
    params = tree_map(build, shapes.params, layouts.params, global_params)
    vec = lambda t, lays: place(t, lays, mesh)
    buffer = None
    if shapes.buffer is not None:
        buffer = StragglerBuffer(
            delta=zeros(shapes.buffer.delta, layouts.buffer.delta),
            age=vec(small.buffer.age, layouts.buffer.age))
    return DistSwarmState(
        params=params, velocity=zeros(shapes.velocity, layouts.velocity),
        best_params=params,
        best_loss=vec(small.best_loss, layouts.best_loss),
        global_params=global_params, gbest_params=global_params,
        gbest_loss=vec(small.gbest_loss, layouts.gbest_loss),
        prev_theta_mean=vec(small.prev_theta_mean, layouts.prev_theta_mean),
        eta=vec(small.eta, layouts.eta), round_idx=0,
        residual=zeros(shapes.residual, layouts.residual),
        ps_residual=zeros(shapes.ps_residual, layouts.ps_residual),
        phy=vec(small.phy, layouts.phy), buffer=buffer)


def _draw_specs(W: int, n_leaves: int) -> RoundDraws:
    """Meta stand-ins of the train step's RoundDraws (the default wire:
    coefficients and seeds; a scenario's wire adds its own draws)."""
    return RoundDraws(coeffs=_meta((W, 3), torch.float32),
                      perms=_meta((W, 0, 0), torch.int64),
                      up_seeds=_meta((W, n_leaves), torch.int32),
                      down_seeds=_meta((n_leaves,), torch.int32),
                      keep=None, fade=None, noise=None, byz_noise=None)


def build_train_step(cfg: ArchConfig, shape: InputShape, mesh,
                     algorithm: str = "mdsl",
                     comm: Optional[CommConfig] = None,
                     population: int = 0) -> BuiltStep:
    """The M-DSL communication round over the mesh. `comm` threads the
    wire config (compression / channel / aggregator / downlink) into the
    round. `population > 0` prices a P-device registry next to the step
    (`population_specs`) and reports its sharded footprint in the
    meta."""
    cfg = _prep_cfg(cfg)
    rules = train_rules(cfg, mesh)
    worker_axes, W = swarm_layout(cfg, mesh)
    model = Transformer(cfg)
    # bound the per-local-step activation footprint at ~8 sequences per
    # device batch (grad accumulation over chunks)
    per_worker = shape.global_batch // max(W, 1)
    micro = cfg.train_microbatches or min(8, max(1, per_worker // 8))
    dcfg = DistSwarmConfig(num_spatial=W, local_steps=1, tau=0.9,
                           microbatches=micro,
                           comm=(comm or CommConfig()).validate(),
                           worker_axes=worker_axes)
    step = (swarm_dist.build_train_step(model.loss, dcfg)
            if algorithm == "mdsl"
            else swarm_dist.fedavg_train_step(model.loss, dcfg))

    specs = input_specs(cfg, shape, mesh)
    param_shapes = model.init(None, "meta")
    state_shapes = swarm_dist.init_state(param_shapes, dcfg)

    wspec = (tuple(worker_axes) if len(worker_axes) != 1 else worker_axes[0]
             ) if worker_axes else None
    pshard = lambda t, w: tree_shardings(
        t, rules, mesh, prefix_axes=1 if w else 0,
        prefix_spec=(wspec,) if w else None)
    scalar = _layout(mesh, ())
    wvec = _layout(mesh, (wspec,))
    state_layouts = DistSwarmState(
        params=pshard(state_shapes.params, True),
        velocity=pshard(state_shapes.velocity, True),
        best_params=pshard(state_shapes.best_params, True),
        best_loss=wvec,
        global_params=pshard(state_shapes.global_params, False),
        gbest_params=pshard(state_shapes.gbest_params, False),
        gbest_loss=scalar, prev_theta_mean=scalar, eta=wvec,
        round_idx=scalar,
        residual=pshard(state_shapes.residual, True),
        ps_residual=pshard(state_shapes.ps_residual, False),
        phy=PhyState(h_re=wvec, h_im=wvec, pathloss_db=wvec, snr_db=wvec,
                     age=wvec),
        # parked late deltas shard like the uplink residual; their ages
        # are a (W,) vector like the phy columns
        buffer=(StragglerBuffer(
                    delta=pshard(state_shapes.buffer.delta, True),
                    age=wvec)
                if state_shapes.buffer is not None else None))

    batch_lay = _shard_batch_specs(specs["batch"], rules, mesh,
                                   worker_axes=worker_axes)
    eval_lay = _shard_batch_specs(specs["eval_batch"],
                                  ShardingRules(rules, batch=None), mesh)

    def fn(state, batch, eval_batch, draws):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with use_rules(rules, mesh), implicit_replication():
            return step(state, batch, eval_batch, draws)

    draws = _draw_specs(W, len(tree_leaves(param_shapes)))
    args = (state_shapes, specs["batch"], specs["eval_batch"], draws)
    layouts = (state_layouts, batch_lay, eval_lay, None)
    meta = {"W": W, "worker_axes": worker_axes, "algorithm": algorithm,
            "dcfg": dcfg, "model": model}
    if population:
        _, _, pop_meta = population_specs(dcfg.comm, population, mesh,
                                          worker_axes)
        meta["population"] = population
        meta["population_table_bytes"] = pop_meta["table_bytes"]
        meta["population_bytes_per_shard"] = pop_meta["bytes_per_shard"]
    return BuiltStep(fn=fn, args=args, rules=rules, cfg=cfg, meta=meta,
                     layouts=layouts)


def population_specs(comm: CommConfig, population: int, mesh,
                     worker_axes: tuple[str, ...]) -> tuple[Any, Any, dict]:
    """Shapes and layouts of a P-device population table on a mesh
    (core/population.py). The table is nine (P,) scalar columns, so it
    shards 1-D over the worker axes like the cohort's phy/eta vectors,
    never an O(P) model pytree. Returns (meta table, Layout tree, meta)
    where meta prices the footprint per shard."""
    specs = pop.table_specs(population)
    wspec = (tuple(worker_axes) if len(worker_axes) != 1 else worker_axes[0]
             ) if worker_axes else None
    vec = _layout(mesh, (wspec,))
    layouts = tree_map(lambda _: vec, specs)
    total = sum(x.numel() * x.element_size() for x in tree_leaves(specs))
    W = 1
    for a in worker_axes:
        W *= axis_size(mesh, a)
    return specs, layouts, {
        "population": population, "table_bytes": total,
        "bytes_per_shard": total // max(W, 1), "worker_axes": worker_axes}


def _serve_cache_shapes(model: Transformer, cfg: ArchConfig, batch: int,
                        cache_len: int) -> PyTree:
    if cfg.cross_attention:
        memory = _meta((batch, cfg.encoder_memory_len, cfg.d_model),
                       getattr(torch, cfg.dtype))
        return model.init_cache(batch, cache_len, "meta", memory=memory,
                                params=model.init(None, "meta"))
    return model.init_cache(batch, cache_len, "meta")


def build_serve_step(cfg: ArchConfig, shape: InputShape, mesh) -> BuiltStep:
    """prefill shapes -> the prefill step; decode shapes -> the decode
    step (one token against a seq_len cache; past 100k tokens the cache
    is context-parallel over "data")."""
    cfg = _prep_cfg(cfg)
    long_ctx = shape.seq_len > 100_000
    rules = serve_rules(cfg, mesh, long_ctx)
    model = Transformer(cfg)
    specs = input_specs(cfg, shape, mesh)
    param_shapes = model.init(None, "meta")
    param_lay = tree_shardings(param_shapes, rules, mesh)
    cache_shapes = _serve_cache_shapes(model, cfg, shape.global_batch,
                                       shape.seq_len)
    cache_lay = tree_shardings(cache_shapes, rules, mesh, table="cache")

    if shape.kind == "prefill":
        batch_lay = _shard_batch_specs(specs["batch"], rules, mesh)

        def prefill(params, batch, cache):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with use_rules(rules, mesh), implicit_replication():
                if cfg.cross_attention:
                    # the memory's K/V of every cross block join the
                    # placed self-attention caches (the zeroed caches
                    # init_cache would make beside them stay on "meta")
                    memory = model.encode(params, batch["frames"])
                    fresh = model.init_cache(
                        batch["tokens"].shape[0], shape.seq_len, "meta",
                        memory=memory, params=params)
                    cache.update({k: v for k, v in fresh.items()
                                  if k.startswith("cross_kv")})
                return model.prefill(params, batch, cache)

        return BuiltStep(fn=prefill,
                         args=(param_shapes, specs["batch"], cache_shapes),
                         rules=rules, cfg=cfg, meta={"mode": "prefill"},
                         layouts=(param_lay, batch_lay, cache_lay))

    tok_lay = _shard_batch_specs({"tokens": specs["tokens"]}, rules,
                                 mesh)["tokens"]

    def decode(params, tokens, cache):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with use_rules(rules, mesh), implicit_replication():
            return model.decode_step(params, tokens, cache)

    return BuiltStep(fn=decode,
                     args=(param_shapes, specs["tokens"], cache_shapes),
                     rules=rules, cfg=cfg,
                     meta={"mode": "decode", "long": long_ctx},
                     layouts=(param_lay, tok_lay, cache_lay))


def build_step(cfg: ArchConfig, shape: InputShape, mesh,
               algorithm: str = "mdsl",
               comm: Optional[CommConfig] = None) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, algorithm, comm=comm)
    return build_serve_step(cfg, shape, mesh)
