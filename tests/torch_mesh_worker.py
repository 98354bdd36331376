"""Spawned gloo process groups for the port's mesh tests (imported by
tests/test_torch_moe_ep.py and tests/test_torch_mesh_steps.py; not a
test module). Each rank runs a case function of this module on a CPU
DeviceMesh and rank 0 writes the whole results, as numpy arrays, to an
npz file the test reads back. The store is a file under the test's tmp
dir (never a fixed TCP port: test workers run side by side), the process
group's timeout is 60 s, and `spawn` stops the ranks and fails past its
own deadline, so a hang fails the test instead of holding the suite.
Imports torch and the port only (no JAX in the ranks)."""
from __future__ import annotations

import dataclasses
import datetime
import os
import time

import numpy as np
import torch

PG_TIMEOUT_S = 60


def start(case: str, mesh_shape, names: tuple, out: str,
          inputs: str, timeout_s: float = 120.0):
    """Start `case` on a (mesh_shape, names) CPU mesh over
    prod(mesh_shape) spawned ranks; `wait` for rank 0's results. A list
    of shapes of one size runs the case on each mesh in turn over the
    same ranks (the results' keys then lead with "<shape>/", e.g.
    "2x1/", and the inputs' keys "<shape>:" go to that mesh only)."""
    import torch.multiprocessing as mp
    shapes = ([tuple(mesh_shape)] if isinstance(mesh_shape[0], int)
              else [tuple(m) for m in mesh_shape])
    world = int(np.prod(shapes[0]))
    ctx = mp.start_processes(_entry, args=(world, out + ".store", case,
                                           shapes, names, out, inputs),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out, f"{case} on {shapes}", time.monotonic() + timeout_s


def wait(handle) -> dict:
    ctx, out, what, deadline = handle
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what}: no end by its deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    with np.load(out) as z:
        return dict(z)


def spawn(*args, **kwargs) -> dict:
    return wait(start(*args, **kwargs))


def _entry(rank, world, store, case, shapes, names, out, inputs):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        with np.load(inputs, allow_pickle=False) as z:
            z = dict(z)
        res = {}
        for shape in shapes:
            name = "x".join(map(str, shape))
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=tuple(names))
            zm = {k: v for k, v in z.items() if ":" not in k}
            zm.update({k.split(":", 1)[1]: v for k, v in z.items()
                       if k.startswith(name + ":")})
            got = CASES[case](mesh, zm)
            res.update(got if len(shapes) == 1 else
                       {f"{name}/{k}": v for k, v in got.items()})
        if rank == 0:
            np.savez(out + ".tmp.npz", **res)
            os.replace(out + ".tmp.npz", out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def full(x) -> np.ndarray:
    x = x.full_tensor() if hasattr(x, "full_tensor") else x
    return x.detach().cpu().numpy()


def _to(tree, device):
    """A tree's tensors moved to `device` (inputs are made on the CPU, so
    a run on a card sees the same values)."""
    from repro_torch.pytree import tree_map
    return tree_map(lambda x: x.to(device) if torch.is_tensor(x) else x,
                    tree)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def moe_cfg(E=8, K=2, cf=None):
    """Reduced qwen3-moe-30b-a3b in f32 at E experts, top K; dropless by
    default (cf = E / K)."""
    from repro_torch.configs.base import get_arch
    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    return dataclasses.replace(cfg, dtype="float32", num_experts=E,
                               experts_per_token=K,
                               moe_capacity_factor=float(E // K)
                               if cf is None else cf)


def moe_ep_case(mesh, z: dict, device="cpu") -> dict:
    """`moe.moe_apply` under EP rules on DTensors (the expert weights
    over "data", the batch too): the all-to-all dispatch through real
    `all_to_all_single`; y, aux and the gradients of sum(y r) + aux."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe
    from repro_torch.sharding.rules import ShardingRules, use_rules
    cfg = moe_cfg()
    rep, split = [Replicate()], [Shard(0)]
    params = {k[2:]: torch.from_numpy(v).to(device) for k, v in z.items()
              if k.startswith("p_")}
    params["norm"] = {"scale": params.pop("norm")}
    place = {"router": rep, "wi": split, "wu": split, "wo": split}
    dp = {k: (DTensor.from_local(v.chunk(mesh.size(0))[mesh.get_local_rank(0)]
                                 if place[k] == split else v, mesh,
                                 place[k]).requires_grad_()
              if k in place else
              {"scale": DTensor.from_local(v["scale"], mesh, rep
                                           ).requires_grad_()})
          for k, v in params.items()}
    x = torch.from_numpy(z["x"]).to(device)
    r = torch.from_numpy(z["r"]).to(device)
    n, me = mesh.size(0), mesh.get_local_rank(0)
    dx = DTensor.from_local(x.chunk(n)[me], mesh, split).requires_grad_()
    dr = DTensor.from_local(r.chunk(n)[me], mesh, split)
    rules = ShardingRules(batch="data", expert="data", moe_ep=True)
    with use_rules(rules, mesh), implicit_replication():
        y, aux = moe.moe_apply(dp, dx, cfg)
        loss = (y * dr).sum() + aux
        leaves = [dx, dp["router"], dp["wi"], dp["wu"], dp["wo"],
                  dp["norm"]["scale"]]
        grads = torch.autograd.grad(loss, leaves)
    names = ["x", "router", "wi", "wu", "wo", "norm"]
    out = {"y": full(y), "aux": full(aux)}
    out.update({f"g_{k}": full(g) for k, g in zip(names, grads)})
    return out


# the layouts `layout_case` runs on each mesh: (region, name, rules). The
# lookup with the tokens split over "data" (the table's gradient a sum
# over the data ranks; its embed dim FSDP-sharded too) and whole on
# every rank; the dispatch under the TP rules (the experts over one axis,
# each expert's products whole) and the FSDP rules (the experts over
# "data", expert_mlp over "model": wo's product a partial sum)
LAYOUTS = {
    "2x2": (("lookup", "split", dict(vocab="model", batch="data",
                                     embed_fsdp="data")),
            ("lookup", "whole", dict(vocab="model")),
            ("dispatch", "tp", dict(batch="data", expert="model")),
            ("dispatch", "fsdp", dict(batch="data", embed_fsdp="data",
                                      expert="data", expert_mlp="model"))),
    "4x1": (("lookup", "whole", dict(vocab="data")),
            ("dispatch", "tp", dict(expert="data"))),
}


LOOKUP_V, LOOKUP_D, LAYOUT_B, LAYOUT_S = 64, 8, 4, 6


def layout_inputs(seed: int = 26) -> dict:
    """`layout_case`'s inputs as numpy arrays, from one seed: a (V, D)
    table, (B, S) tokens (with repeats: B S = 24 draws of 64 rows) and
    the lookup's output weights; a (B, S, d_model) batch, its output
    weights and `moe_cfg`'s MoE weights from the port's init."""
    from repro_torch.models import moe
    rng = np.random.default_rng(seed)
    cfg = moe_cfg()
    p = moe.moe_init(torch.Generator().manual_seed(seed), cfg, "cpu")
    B, S, D = LAYOUT_B, LAYOUT_S, cfg.d_model
    return {
        "table": (0.01 * rng.standard_normal((LOOKUP_V, LOOKUP_D))
                  ).astype(np.float32),
        "tokens": rng.integers(0, LOOKUP_V, (B, S)).astype(np.int32),
        "r_emb": rng.standard_normal((B, S, LOOKUP_D)).astype(np.float32),
        "x": (0.1 * rng.standard_normal((B, S, D))).astype(np.float32),
        "r": rng.standard_normal((B, S, D)).astype(np.float32),
        "p_norm": p["norm"]["scale"].numpy(),
        **{f"p_{k}": p[k].numpy() for k in ("router", "wi", "wu", "wo")}}


def _put(x: torch.Tensor, names: tuple, rules, mesh):
    """x (the same on every rank) as a DTensor laid out as `rules` give
    `names`, wanting a gradient when it is a float."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.rules import fit, placements
    pl = placements(fit(rules.spec(names), x.shape, mesh), mesh)
    d = distribute_tensor(x, mesh, pl, src_data_rank=None)
    return d.requires_grad_() if x.is_floating_point() else d


def layout_case(mesh, z: dict, device="cpu") -> dict:
    """`layers.embed` (the vocab-parallel lookup) and `moe.moe_apply`
    (the expert-sharded dense dispatch: no EP) on DTensors laid out by
    each of LAYOUTS' rules for this mesh: the lookup's output and the
    gradient of sum(out r) to the table, the dispatch's y, aux and the
    gradients of sum(y r) + aux, each whole; and the most elements of
    an expert weight or gradient, and of the table, that the rank held
    (`_Largest`)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import layers, moe
    from repro_torch.sharding.rules import ShardingRules, use_rules
    name = "x".join(map(str, mesh.shape))
    t = {k: torch.from_numpy(v).to(device) for k, v in z.items()}
    cfg = moe_cfg()
    out = {}
    for region, label, r in LAYOUTS[name]:
        rules = ShardingRules(r)
        key = f"{region}|{label}|"
        seen = _Largest()
        with use_rules(rules, mesh), implicit_replication():
            if region == "lookup":
                tbl = _put(t["table"], ("vocab", "embed_fsdp"), rules, mesh)
                tok = _put(t["tokens"], ("batch", None), rules, mesh)
                rr = _put(t["r_emb"], ("batch", "seq", "embed"), rules, mesh)
                with seen:
                    o = layers.embed({"table": tbl}, tok)
                    (g,) = torch.autograd.grad((o * rr).sum(), [tbl])
                dense = torch.empty(o.shape, device="meta").stride()
                out.update({key + "out": full(o), key + "g_table": full(g),
                            key + "contiguous": np.array(o.stride() == dense)})
            else:
                p = {k: _put(t["p_" + k], names, rules, mesh) for k, names in (
                    ("router", ("embed_fsdp", None)),
                    ("wi", ("expert", "embed_fsdp", "expert_mlp")),
                    ("wu", ("expert", "embed_fsdp", "expert_mlp")),
                    ("wo", ("expert", "expert_mlp", "embed_fsdp")))}
                p["norm"] = {"scale": _put(t["p_norm"], (None,), rules,
                                           mesh)}
                x = _put(t["x"], ("batch", "seq", "embed"), rules, mesh)
                rr = _put(t["r"], ("batch", "seq", "embed"), rules, mesh)
                leaves = [x, p["router"], p["wi"], p["wu"], p["wo"],
                          p["norm"]["scale"]]
                with seen:
                    y, aux = moe.moe_apply(p, x, cfg)
                    grads = torch.autograd.grad((y * rr).sum() + aux, leaves)
                out.update({key + "y": full(y), key + "aux": full(aux)})
                out.update({key + f"g_{k}": full(g) for k, g in zip(
                    ("x", "router", "wi", "wu", "wo", "norm"), grads)})
        out[key + "most"] = np.array(seen.most)
    if name == "2x2" and "dryrun" in z:   # both layouts, cost model, real
        out.update({f"dryrun|{k}": np.array(v) for k, v in dryrun_real(
            *DRYRUN_LAYOUT, mesh, device=device).items()})
    return out


def layout_one_process(z: dict, region: str, device="cpu") -> dict:
    """`layout_case`'s results with no mesh: the port's one-process
    lookup or dispatch on the same inputs."""
    from repro_torch.models import layers, moe
    t = {k: torch.from_numpy(v).to(device) for k, v in z.items()
         if v.dtype != np.bool_}
    if region == "lookup":
        tbl = t["table"].clone().requires_grad_()
        out = layers.embed({"table": tbl}, t["tokens"])
        (g,) = torch.autograd.grad((out * t["r_emb"]).sum(), [tbl])
        return {"out": full(out), "g_table": full(g)}
    leaves = [t[k].clone().requires_grad_() for k in
              ("x", "p_router", "p_wi", "p_wu", "p_wo", "p_norm")]
    p = dict(zip(("router", "wi", "wu", "wo"), leaves[1:5]),
             norm={"scale": leaves[5]})
    y, aux = moe.moe_apply(p, leaves[0], moe_cfg())
    g = torch.autograd.grad((y * t["r"]).sum() + aux, leaves)
    out = {"y": full(y), "aux": full(aux)}
    out.update({f"g_{k}": full(x) for k, x in zip(
        ("x", "router", "wi", "wu", "wo", "norm"), g)})
    return out


def layout_exact(key: str, label: str, rules: dict) -> bool:
    """Whether `layout_case`'s result `key` of layout `label` is held
    bitwise to one process: all but the FSDP dispatch (wo's partial sums
    over "model") and the sums over rows that the rules' batch layout
    splits (the norm scale's and the table's gradients)."""
    split = key in ("g_norm", "g_table") and "batch" in rules
    return label != "fsdp" and not split


def vocab_virtual(table: torch.Tensor, tokens: torch.Tensor,
                  g: torch.Tensor, n: int) -> tuple:
    """The vocab-parallel lookup over n virtual vocab shards in one
    process: each shard's masked lookup (`layers.vocab_shard_lookup`),
    summed in shard order as the all-reduce sums them, and each shard's
    table gradient from the output gradient g (`vocab_shard_grad`),
    concatenated. Returns (output, table gradient)."""
    from repro_torch.models import layers
    rows = table.shape[0] // n
    out, grads = None, []
    for s in range(n):
        part, idx = layers.vocab_shard_lookup(
            table[s * rows:(s + 1) * rows], tokens, s * rows)
        out = part if out is None else out + part
        grads.append(layers.vocab_shard_grad(g, idx, rows))
    return out, torch.cat(grads)


def dispatch_virtual(params: dict, h: torch.Tensor, cfg, n_expert: int,
                     n_mlp: int) -> tuple:
    """The expert-sharded dense dispatch (`moe._expert_sharded`) over
    n_expert x n_mlp virtual shards in one process: routing and pack
    whole, each shard's products on its experts' rows and its f columns
    of the weights, the f parts summed in f32 in shard order (as the
    all-reduce sums them) and the expert blocks concatenated, then the
    combine. h is pre-normed (B, S, D).
    Returns (y, aux)."""
    from repro_torch.models import moe
    B, S, D = h.shape
    hf = h.reshape(B * S, D)
    gates, idx, counts, aux = moe.route(hf, params["router"], cfg)
    xs, dest, sort_idx = moe.pack(hf, idx, counts, cfg)
    El = cfg.num_experts // n_expert
    fl = params["wi"].shape[-1] // n_mlp
    blocks = []
    for e in range(n_expert):
        es = slice(e * El, (e + 1) * El)
        ys = None
        for c in range(n_mlp):
            cs = slice(c * fl, (c + 1) * fl)
            part = moe.expert_ffn(xs[es], params["wi"][es, :, cs],
                                  params["wu"][es, :, cs],
                                  params["wo"][es, cs], partial=n_mlp > 1)
            ys = part if ys is None else ys + part
        blocks.append(ys.to(h.dtype))
    y = moe.combine(torch.cat(blocks), dest, sort_idx, gates, h.dtype)
    return y.reshape(B, S, D), aux


def _f32(arch):
    from repro_torch.configs.base import get_arch
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    return moe_cfg() if arch.startswith("qwen3") else cfg


def mesh_steps_case(mesh, z: dict) -> dict:
    """`launch.steps.build_step` train, prefill and decode for each arch
    of z["archs"] on this mesh (and z["extra"]'s (arch, kind) pairs); the
    inputs (params, batches, draws, caches) are made here from the
    seeds, as `one_rank` makes them. With z["boundary_seed"], also
    `boundary_case` on the "data" axis."""
    out = {}
    pairs = [(str(a), str(k)) for a in z["archs"] for k in z["kinds"]]
    pairs += [(str(a), str(k)) for a, k in z.get("extra", [])]
    for arch, kind in pairs:
        res = run_step(arch, kind, mesh)
        out.update({f"{arch}|{kind}|{k}": v for k, v in res.items()})
    if "boundary_seed" in z:        # the kernel boundary on the data axis
        res = boundary_case(mesh["data"], {"seed": z["boundary_seed"]})
        out.update({f"boundary|{k}": v for k, v in res.items()})
    return out


TRAIN = (128, 8)         # (seq, global batch): the reference mini-mesh's
DECODE = (256, 8)
PREFILL = (64, 8)
PROMPT = 32              # tokens prefilled before the decode steps


def _inputs(arch, kind, W=None, device="cpu"):
    """The step's inputs as whole tensors, from seeds: (cfg, params, args
    other than params); a FedAvg round's are a train round's."""
    from repro_torch.core import swarm_dist
    from repro_torch.launch import steps
    from repro_torch.models.transformer import Transformer
    cfg = steps._prep_cfg(_f32(arch))
    model = Transformer(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device)
    if kind in ("train", "fedavg") or kind in WIRES:
        S, GB = TRAIN
        B = GB // W
        toks = torch.randint(0, cfg.vocab_size, (W, B, S), generator=gen)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
        et = torch.randint(0, cfg.vocab_size, (steps.EVAL_BATCH, S),
                           generator=gen)
        ev = {"tokens": et, "labels": torch.roll(et, -1, -1)}
        return cfg, model, params, (batch, ev, gen)
    if kind == "prefill":
        S, B = PREFILL
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
        return cfg, model, params, ({"tokens": toks},
                                    model.init_cache(B, S, device))
    S, B = DECODE
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT + 2), generator=gen)
    cache = model.init_cache(B, S, device)
    with torch.no_grad():
        model.prefill(params, {"tokens": toks[:, :PROMPT]}, cache)
    return cfg, model, params, (toks[:, PROMPT:PROMPT + 1],
                                toks[:, PROMPT + 1:], cache)


def run_init(arch: str, mesh) -> dict:
    """`steps.init_placed` of the serve params on this mesh: each leaf
    against the whole draw, and how many leaves a layout shards."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.pytree import tree_leaves
    built = steps.build_step(_f32(arch), InputShape("p", *PREFILL,
                                                    "prefill"), mesh)
    model = steps.Transformer(built.cfg)
    placed = steps.init_placed(model, torch.Generator().manual_seed(0),
                               built.layouts[0], mesh, "cpu")
    whole = model.init(torch.Generator().manual_seed(0), "cpu")
    diff = max(float((torch.from_numpy(full(a)) - b).abs().max())
               for a, b in zip(tree_leaves(placed), tree_leaves(whole)))
    sharded = sum(any(p.is_shard() for p in a.placements)
                  for a in tree_leaves(placed))
    smaller = all(a.to_local().numel() * 2 <= a.numel()
                  for a in tree_leaves(placed)
                  if any(p.is_shard() for p in a.placements))
    # the train state: init_placed's global params, then the stacks
    from repro_torch.core import swarm_dist
    tb = steps.build_step(_f32(arch), InputShape("t", *TRAIN, "train"), mesh)
    lay = tb.layouts[0]
    g = steps.init_placed(tb.meta["model"], torch.Generator().manual_seed(0),
                          lay.global_params, mesh, "cpu")
    st = steps.init_state_placed(g, tb.meta["dcfg"], lay, mesh)
    want = swarm_dist.init_state(tb.meta["model"].init(
        torch.Generator().manual_seed(0), "cpu"), tb.meta["dcfg"])
    got_leaves = tree_leaves(st._replace(round_idx=None))
    sdiff = max(float((torch.from_numpy(full(a)).float()
                       - b.float()).abs().max())
                for a, b in zip(got_leaves,
                                tree_leaves(want._replace(round_idx=None))))
    ssmaller = all(a.to_local().numel() * 2 <= a.numel() for a in got_leaves
                   if any(p.is_shard() for p in a.placements))
    return {"diff": np.array(max(diff, sdiff)), "sharded": np.array(sharded),
            "smaller": np.array(smaller and ssmaller)}


# train rounds on another wire than the default (the kind's name -> its
# CommConfig fields): int8 takes the packed route (quantize-pack with
# error feedback, then wire_agg over the gathered payloads), deadline
# the straggler route (`_comm` sets the deadline)
WIRES = {"int8": {"compressor": "int8"},
         "deadline": {"pathloss_spread_db": 6.0, "staleness_gamma": 0.5}}


def _comm(kind: str, arch: str, mesh):
    """The round's wire. Under a deadline, pathloss puts the last worker
    6 dB below the first and the deadline sits between their airtimes,
    so the last goes late whenever selected and its delta is parked."""
    from repro_torch.comm import budget, phy
    from repro_torch.comm.budget import CommConfig
    from repro_torch.launch import steps
    from repro_torch.models.transformer import Transformer
    c = CommConfig(**WIRES.get(kind, {}))
    if kind != "deadline":
        return c
    cfg = steps._prep_cfg(_f32(arch))
    W = steps.swarm_layout(cfg, mesh)[1]
    air = budget.worker_airtime_s(c, budget.worker_payload_bytes(
        c, Transformer(cfg).init(None, "meta"), W),
        phy.init_state(c, W, "cpu").snr_db)
    return c._replace(round_deadline_s=float(torch.sqrt(air[0] * air[-1])))


class _Largest(torch.utils._python_dispatch.TorchDispatchMode):
    """The most elements of any tensor an op returned while on (of a
    DTensor, its local shard: what the rank holds)."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                loc = getattr(t, "_local_tensor", t)
                self.most = max(self.most, loc.numel())
        return out


def _watched_round(fn, args) -> tuple:
    """fn(*args) (a mesh round) with the ops inside its wire watched;
    returns (state, telemetry, the most elements of a tensor the wire
    made)."""
    from repro_torch.core import swarm_dist
    seen, orig = _Largest(), swarm_dist._MeshFleet.wire

    def wire(self, *a, **k):
        with seen:
            return orig(self, *a, **k)
    swarm_dist._MeshFleet.wire = wire
    try:
        st, info = fn(*args)
    finally:
        swarm_dist._MeshFleet.wire = orig
    return st, info, seen.most


def _wire_bounds(params, mesh) -> tuple[int, int]:
    """Over the placed (W, ...) params: the most elements of a leaf's
    rows on this rank once gathered over the mesh dims that shard the
    worker dim, and the most elements of a whole leaf that a mesh dim
    shards along a model dim (0 where none does)."""
    from repro_torch.pytree import tree_leaves
    bound = whole = 0
    for x in tree_leaves(params):
        over_workers = int(np.prod([mesh.size(d) for d, p in
                                    enumerate(x.placements)
                                    if p.is_shard(0)]))
        bound = max(bound, x.to_local().numel() * over_workers)
        if any(p.is_shard() and p.dim > 0 for p in x.placements):
            whole = max(whole, x.numel())
    return bound, whole


def run_step(arch: str, kind: str, mesh, device="cpu") -> dict:
    """One `build_step` on the mesh: train (one M-DSL round; `WIRES`' and
    fedavg's are train rounds too), prefill, or two decode steps, the
    inputs moved to `device`; the whole results as numpy arrays. A
    round's also say how large a tensor its wire made on this rank
    (`_watched_round`) beside `_wire_bounds`."""
    if kind == "init":
        return run_init(arch, mesh)
    from repro_torch.configs.base import InputShape
    from repro_torch.core import swarm_dist
    from repro_torch.launch import steps
    from repro_torch.pytree import tree_leaves
    train = kind in ("train", "fedavg") or kind in WIRES
    shape = (InputShape("train", *TRAIN, "train") if train else
             {"prefill": InputShape("prefill", *PREFILL, "prefill"),
              "decode": InputShape("decode", *DECODE, "decode")}[kind])
    built = steps.build_step(_f32(arch), shape, mesh,
                             algorithm="fedavg" if kind == "fedavg"
                             else "mdsl", comm=_comm(kind, arch, mesh))
    lay = built.layouts
    if train:
        dcfg = built.meta["dcfg"]
        cfg, model, params, (batch, ev, gen) = _inputs(arch, kind,
                                                       dcfg.num_spatial)
        draws = swarm_dist.sample_draws(gen, dcfg, params, "cpu", 0)
        params, batch, ev, draws = _to((params, batch, ev, draws), device)
        placed = steps.place(swarm_dist.init_state(params, dcfg), lay[0],
                             mesh)
        st, info, most = _watched_round(built.fn, (
            placed, steps.place(batch, lay[1], mesh),
            steps.place(ev, lay[2], mesh), draws))
        bound, whole = _wire_bounds(placed.params, mesh)
        res = {f"global{i}": full(x)
               for i, x in enumerate(tree_leaves(st.global_params))}
        res.update({f"params{i}": full(x)
                    for i, x in enumerate(tree_leaves(st.params))})
        res.update(losses=full(info.losses), theta=full(info.theta),
                   mask=full(info.mask), global_loss=full(info.global_loss),
                   wire_most=np.array(most), wire_bound=np.array(bound),
                   whole_leaf=np.array(whole))
        return res
    cfg, model, params, rest = _inputs(arch, kind)
    params, rest = _to((params, rest), device)
    pp = steps.place(params, lay[0], mesh)
    with torch.no_grad():
        if kind == "prefill":
            batch, cache = rest
            logits, _ = built.fn(pp, steps.place(batch, lay[1], mesh),
                                 steps.place(cache, lay[2], mesh))
            return {"logits": full(logits)}
        t1, t2, cache = rest
        c = steps.place(cache, lay[2], mesh)
        l1, c = built.fn(pp, steps.place(t1, lay[1], mesh), c)
        l2, c = built.fn(pp, steps.place(t2, lay[1], mesh), c)
    return {"logits1": full(l1), "logits2": full(l2)}


def one_rank(arch: str, kind: str, W: int = 1, draws=None,
             device="cpu") -> dict:
    """The same step with no mesh: the port's one-process functions
    (`swarm_dist` with no worker axes, `Transformer.prefill` /
    `decode_step`) on the same inputs; `draws` overrides the round's."""
    from repro_torch.core import swarm_dist
    from repro_torch.pytree import tree_leaves
    cfg, model, params, rest = _inputs(arch, kind, W)
    if kind in ("train", "fedavg") or kind in WIRES:
        batch, ev, gen = rest
        from repro_torch.launch import steps
        from repro_torch.configs.base import InputShape

        class _One:
            shape = {"data": W, "model": 1}
            axis_names = ("data", "model")
        dcfg = steps.build_step(_f32(arch), InputShape("t", *TRAIN, "train"),
                                _One(), comm=_comm(kind, arch, _One())
                                ).meta["dcfg"]._replace(worker_axes=())
        d = swarm_dist.sample_draws(gen, dcfg, params, "cpu", 0)
        params, batch, ev, d = _to((params, batch, ev,
                                    d if draws is None else draws), device)
        state = swarm_dist.init_state(params, dcfg)
        make = (swarm_dist.fedavg_train_step if kind == "fedavg"
                else swarm_dist.build_train_step)
        st, info = make(model.loss, dcfg)(state, batch, ev, d)
        res = {f"global{i}": full(x)
               for i, x in enumerate(tree_leaves(st.global_params))}
        res.update({f"params{i}": full(x)
                    for i, x in enumerate(tree_leaves(st.params))})
        res.update(losses=full(info.losses), theta=full(info.theta),
                   mask=full(info.mask), global_loss=full(info.global_loss))
        return res
    params, rest = _to((params, rest), device)
    with torch.no_grad():
        if kind == "prefill":
            batch, cache = rest
            return {"logits": full(model.prefill(params, batch, cache)[0])}
        t1, t2, cache = rest
        l1, cache = model.decode_step(params, t1, cache)
        l2, _ = model.decode_step(params, t2, cache)
    return {"logits1": full(l1), "logits2": full(l2)}


def boundary_case(mesh, z: dict, device="cpu") -> dict:
    """Each kernel wrapper handed DTensors on this 1-D mesh, laid out
    as its kernel allows (run on the shards) and as it does not (a
    gather to Replicate() first, counted): the whole results, and the
    calls counted under each kernel's name."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.pso_update.ops import pso_update
    from repro_torch.kernels.quant_pack import ops as qp
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.wire_agg.ops import wire_aggregate
    from repro_torch.sharding import boundary
    g = torch.Generator().manual_seed(int(z["seed"]))
    n = mesh.size(0)

    def put(x, p):
        x = x.to(device)
        if p.is_partial():   # a partial sum: each rank holds x / n
            return DTensor.from_local(x / n, mesh, [Partial()])
        return distribute_tensor(x, mesh, [p], src_data_rank=None)

    def r(*shape):
        return torch.randn(shape, generator=g).to(device)
    out = {}
    boundary.reset_redistributions()
    q, k, v = r(4, 16, 4, 8), r(4, 16, 2, 8), r(4, 16, 2, 8)
    out["flash_want"] = full(flash_attention(q, k, v))
    for name, p in (("batch", Shard(0)), ("heads", Shard(2)),
                    ("seq", Shard(1))):
        out[f"flash_{name}"] = full(flash_attention(
            put(q, p), put(k, p), put(v, p)))
    h0, a, b = (r(4, 8), torch.rand((4, 16, 8), generator=g).to(device),
                r(4, 16, 8))
    st, fin = rglru_scan(h0, a, b)
    out["scan_want"] = full(torch.cat([st.reshape(-1), fin.reshape(-1)]))
    for name, p, p0 in (("batch", Shard(0), Shard(0)),
                        ("channel", Shard(2), Shard(1)),
                        ("seq", Shard(1), Replicate())):
        st, fin = rglru_scan(put(h0, p0), put(a, p), put(b, p))
        out[f"scan_{name}"] = np.concatenate([full(st).reshape(-1),
                                              full(fin).reshape(-1)])
    W = 2 * n
    coefs = torch.rand((W, 4), generator=g).to(device)
    w, vel, wl, d = r(W, 6, 8), r(W, 6, 8), r(W, 6, 8), r(W, 6, 8)
    wg = r(6, 8)
    pw, pv = pso_update(coefs, w, vel, wl, wg, d)
    out["pso_want"] = full(torch.cat([pw, pv]))
    for name, p, pg in (("workers", Shard(0), Replicate()),
                        ("rows", Shard(1), Shard(0)),
                        ("partial", Partial(), Replicate())):
        args = [put(t, p) for t in (w, vel, wl)]
        nw, nv = pso_update(coefs, *args, put(wg, pg), put(d, p))
        out[f"pso_{name}"] = np.concatenate([full(nw), full(nv)])
    x, res = r(W, 300, 7), r(W, 300, 7)
    seeds = torch.randint(0, 2**31 - 1, (W,), generator=g,
                          dtype=torch.int32).to(device)
    pk, sc, nr = qp.quantize_pack_ef(x, res, seeds, bits=4)
    dq = qp.dequantize_unpack(pk, sc, (300, 7), bits=4)
    mask = torch.tensor([1.0, 0.0] * n, device=device)
    agg = wire_aggregate(pk, sc, mask, shape=(300, 7), bits=4)
    out["wire_want"] = np.concatenate([full(t.reshape(-1).float())
                                       for t in (pk, sc, nr, dq, agg)])
    for name, p in (("workers", Shard(0)), ("rows", Shard(1))):
        dpk, dsc, dnr = qp.quantize_pack_ef(put(x, p), put(res, p),
                                            put(seeds, Shard(0)), bits=4)
        ddq = qp.dequantize_unpack(dpk, dsc, (300, 7), bits=4)
        dagg = wire_aggregate(dpk, dsc, put(mask, Shard(0)),
                              shape=(300, 7), bits=4)
        out[f"wire_{name}"] = np.concatenate([
            full(t).reshape(-1).astype(np.float32)
            for t in (dpk, dsc, dnr, ddq, dagg)])
    counts = boundary.redistributions()
    out["counts_names"] = np.array(sorted(counts))
    out["counts"] = np.array([counts[k] for k in sorted(counts)])
    return out


# a Qwen3-MoE prefill on a (2, 2) mesh under the serve rules: the table
# over "model" (the vocab-parallel lookup) and the 8 experts over "model"
# with no EP (the expert-sharded dispatch)
DRYRUN_LAYOUT = ("qwen3-moe-30b-a3b", "prefill")
DRYRUN = (("smollm-360m", "train"), ("smollm-360m", "prefill"),
          DRYRUN_LAYOUT)


def _counts(summary: dict) -> dict:
    """The numbers a dry-run is held to, flat: FLOPs, HBM bytes, the
    collectives' bytes and counts by kind, the live bytes' peak."""
    out = {"flops": summary["flops"], "hbm_bytes": summary["hbm_bytes"],
           "peak_bytes": summary["memory"]["peak_bytes"],
           "argument_bytes": summary["memory"]["argument_bytes"]}
    for k, v in summary["collectives"]["by_kind_bytes"].items():
        out[f"{k} bytes"] = v
    for k, v in summary["collectives"]["by_kind_count"].items():
        out[f"{k} count"] = v
    return out


def _own(tree):
    """`tree` with each DTensor shard in storage of its own (a shard
    `steps.place` cut from a whole tensor is a view that keeps the whole
    alive), as each rank of a run holds it; leaves that are one object
    stay one."""
    from repro_torch.pytree import tree_map
    from repro_torch.sharding.rules import is_dtensor
    memo = {}

    def one(x):
        if not is_dtensor(x) or id(x) in memo:
            return memo.get(id(x), x)
        loc = x.to_local()
        if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
            from torch.distributed.tensor import DTensor
            memo[id(x)] = DTensor.from_local(loc.clone(), x.device_mesh,
                                             x.placements, run_check=False)
        else:
            memo[id(x)] = x
        return memo[id(x)]

    return tree_map(one, tree)


def _gen(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _as_specs(batch: dict, specs: dict) -> dict:
    """A batch's tensors in the dtypes of the step's input specs (int32
    tokens and labels)."""
    return {k: v.to(specs[k].dtype) for k, v in batch.items()}


def dryrun_real(arch: str, kind: str, mesh, device="cpu") -> dict:
    """This rank's cost-model counts (`launch.op_costmodel`) of one
    `build_step` train round or prefill of reduced f32 `arch` on `mesh`,
    run on real tensors placed as the step's layouts say."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core import swarm_dist
    from repro_torch.launch import dryrun, op_costmodel, steps
    shape = (InputShape("train", *TRAIN, "train") if kind == "train"
             else InputShape("prefill", *PREFILL, "prefill"))
    built = steps.build_step(_f32(arch), shape, mesh)
    lay = built.layouts
    own = lambda tree, lays: _own(steps.place(tree, lays, mesh))
    if kind == "train":
        dcfg = built.meta["dcfg"]
        cfg, model, params, (batch, ev, gen) = _inputs(arch, kind,
                                                       dcfg.num_spatial)
        draws = swarm_dist.sample_draws(gen, dcfg, params, "cpu", 0)
        batch, ev = (_as_specs(b, m) for b, m in ((batch, built.args[1]),
                                                  (ev, built.args[2])))
        batch, ev, draws = _to((batch, ev, draws), device)
        # the production placement: each rank draws its own shards
        glob = steps.init_placed(model, _gen(device), lay[0].global_params,
                                 mesh, device)
        state = _own(steps.init_state_placed(glob, dcfg, lay[0], mesh))
        args = (state, own(batch, lay[1]), own(ev, lay[2]), draws)
    else:
        cfg, model, params, (batch, cache) = _inputs(arch, kind)
        # the step's batch spec carries labels too (unread by a prefill)
        batch = _as_specs(dict(batch, labels=torch.roll(
            batch["tokens"], -1, -1)), built.args[1])
        batch, cache = _to((batch, cache), device)
        args = (steps.init_placed(model, _gen(device), lay[0], mesh, device),
                own(batch, lay[1]), own(cache, lay[2]))
    out, cm = op_costmodel.count_step(built.fn, args,
                                      parts=dryrun.arg_parts(built, args))
    return _counts(cm.summary(out))


def dryrun_fake(arch: str, kind: str, mesh_shape: tuple, rank: int) -> dict:
    """The same counts from the dry-run: rank `rank` of a fake process
    group of prod(mesh_shape) ranks, fake tensors. Initialises and
    destroys its own fake group (none may be live)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, steps
    shape = (InputShape("train", *TRAIN, "train") if kind == "train"
             else InputShape("prefill", *PREFILL, "prefill"))
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=int(np.prod(mesh_shape)))
    try:
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        built = steps.build_step(_f32(arch), shape, mesh)
        summary, _, _ = dryrun.dry_run(built, mesh, "cpu")
        return _counts(summary)
    finally:
        dist.destroy_process_group()
        dryrun.forget_meshes()


CASES = {"moe_ep": moe_ep_case, "mesh_steps": mesh_steps_case,
         "boundary": boundary_case, "layout": layout_case}
