"""The sharded path's vocab-parallel embedding lookup (`models/layers.embed`
on a table sharded over the vocab) and the expert-sharded dense MoE
dispatch (`models/moe._expert_sharded`, the layout when EP does not
apply), on the CPU in f32.

- Spawned gloo ranks (`tests/torch_mesh_worker.py` `layout_case`, one
  spawn of four ranks over a (2, 2) and a (4, 1) mesh) hold each layout
  of `LAYOUTS` to the port's one-process functions on the same inputs
  (`layout_inputs`, from one seed):
  - the lookup's output bitwise, and its table gradient bitwise where
    every rank sees the whole tokens; with the tokens split over two
    data ranks (the table's embed dim FSDP-sharded too) a row's gradient
    is the sum of its two halves' sums, where one process adds the
    tokens in one run: within TOL;
  - the dispatch under the TP rules (the experts over one mesh axis,
    each expert's products whole) bitwise: y, aux and the gradients of
    x, the router and the expert weights; the norm scale's gradient is
    bitwise where the batch is whole, and within TOL where the rules
    split the batch over "data" (its sum over the rows is then cut by
    the batch's layout, not by the dispatch);
  - the dispatch under the FSDP rules (the experts over "data",
    expert_mlp over "model": wo's product is a partial sum over "model",
    reduced there) within TOL x max(1, the leaf's largest |g|), the EP
    tests' rule for f32 (2 bf16 ulps in bf16, 1e-5 relative in f32);
  - no rank holds another rank's expert weights or their gradients, or
    more of the table than its vocab shard (the largest tensor any op
    returned on rank 0, `_Largest`, is at most a shard, or the lookup's
    own output);
  - the cost model's counts of a Qwen3-MoE prefill on the (2, 2) mesh,
    which takes both layouts, over real tensors equal the dry-run's
    over fake tensors, number for number.
- The one-process stages over n virtual shards (`vocab_virtual`,
  `dispatch_virtual`, which chip_smoke.py runs on the card at full
  width) against the whole computation and the JAX reference's `embed`
  and `moe_apply`.
- The dry-run of a reduced Qwen3-MoE train round on a fake (8, 2) mesh
  (the eval batch of 4 does not divide the 8-way expert axis, so the
  dispatch takes the dense path, as on the 16 x 16 mesh): no all-gather
  from the lookup, and each rank's expert products are its E/8 experts'
  and f/2 columns'.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import torch_mesh_worker as mw
from repro.configs.base import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, steps
from repro_torch.models import layers, moe

TOL = 1e-5
V, DE, B, S = mw.LOOKUP_V, mw.LOOKUP_D, mw.LAYOUT_B, mw.LAYOUT_S
CASES = [(m, region, label) for m, cases in mw.LAYOUTS.items()
         for region, label, _ in cases]


@pytest.fixture(scope="module")
def setup():
    """The reference's config of `mw.moe_cfg()` and the numpy inputs."""
    jc = dataclasses.replace(jget_arch("qwen3-moe-30b-a3b").reduced(),
                             dtype="float32", num_experts=8,
                             experts_per_token=2, moe_capacity_factor=4.0)
    return jc, mw.layout_inputs()


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Rank 0's results of every layout on both meshes (one spawn)."""
    d = tmp_path_factory.mktemp("layout")
    np.savez(d / "in.npz", dryrun=np.array(True), **setup[1])
    return mw.spawn("layout", [(2, 2), (4, 1)], ("data", "model"),
                    str(d / "out.npz"), str(d / "in.npz"), timeout_s=150)


@pytest.mark.parametrize("mesh,region,label", CASES,
                         ids=[f"{m}-{r}-{l}" for m, r, l in CASES])
def test_layout_matches_one_process(ranks, setup, mesh, region, label):
    _, z = setup
    rules = dict(next(r for rg, lb, r in mw.LAYOUTS[mesh]
                      if (rg, lb) == (region, label)))
    key = f"{mesh}/{region}|{label}|"
    want = mw.layout_one_process(z, region)
    for k, w in want.items():
        got = ranks[key + k]
        assert got.shape == w.shape, k
        if mw.layout_exact(k, label, rules):
            np.testing.assert_array_equal(got, w, err_msg=key + k)
        else:
            tol = TOL * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(got, w, rtol=0, atol=tol,
                                       err_msg=key + k)
    # what the rank held: its vocab shard (and the gradient's drop row)
    # or the output, or its experts' (and f columns') part of a weight
    size = dict(zip(("data", "model"), map(int, mesh.split("x"))))
    if region == "lookup":
        # the output's global strides contiguous (not scaled by shards)
        assert ranks[key + "contiguous"]
        rows = max(V // size[rules["vocab"]] + 1, B * S)
        assert rows < V and ranks[key + "most"] <= rows * DE
    else:
        cfg = mw.moe_cfg()
        cut = size[rules["expert"]] * size.get(rules.get("expert_mlp"), 1)
        whole = cfg.num_experts * cfg.d_model * cfg.d_ff
        assert ranks[key + "most"] <= whole // cut


def test_mesh_counts_equal_the_dry_run(ranks):
    """Rank 0 of a Qwen3-MoE prefill on the (2, 2) mesh (the lookup over
    "model" and the 8 experts over "model"): the cost model's counts
    over real tensors equal the dry-run's over fake tensors, and both
    show the lookup's all-reduce and no all-gather of the table."""
    real = {k.split("|", 1)[1]: v.item() for k, v in ranks.items()
            if k.startswith("2x2/dryrun|")}
    fake = mw.dryrun_fake(*mw.DRYRUN_LAYOUT, (2, 2), 0)
    assert real == fake
    assert real["all-reduce count"] > 0


@pytest.mark.parametrize("n", [1, 4])
def test_virtual_vocab_shards(setup, n):
    """The lookup over n virtual vocab shards: the output bitwise the
    one-process lookup and the reference's `jnp.take`, the table
    gradient bitwise the one-process autograd's (the reference's XLA
    scatter-add within 1e-7)."""
    _, z = setup
    tbl, tok = torch.from_numpy(z["table"]), torch.from_numpy(z["tokens"])
    g = torch.from_numpy(z["r_emb"])
    out, gt = mw.vocab_virtual(tbl, tok, g, n)
    t = tbl.clone().requires_grad_()
    (want,) = torch.autograd.grad(F.embedding(tok, t), [t], g)
    np.testing.assert_array_equal(out.numpy(), F.embedding(tok, tbl).numpy())
    np.testing.assert_array_equal(gt.numpy(), want.numpy())
    jt = jnp.asarray(z["table"])
    ref = jlayers.embed({"table": jt}, jnp.asarray(z["tokens"]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    jg = jax.grad(lambda t: (jlayers.embed({"table": t},
                                           jnp.asarray(z["tokens"]))
                             * z["r_emb"]).sum())(jt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("n_expert,n_mlp", [(4, 1), (2, 2)])
def test_virtual_expert_shards(setup, n_expert, n_mlp):
    """The dispatch over n_expert x n_mlp virtual shards: bitwise the
    one-process dispatch with whole f, within TOL with f cut; and within
    the reference MoE tests' tolerance (tests/test_torch_moe.py: 1e-5)
    of the reference's `moe_apply`."""
    jc, z = setup
    cfg = mw.moe_cfg()
    pj = {k: z["p_" + k] for k in ("router", "wi", "wu", "wo")}
    pj["norm"] = {"scale": z["p_norm"]}
    p = bridge.tree_from_numpy(pj)
    x = torch.from_numpy(z["x"])
    h = layers.rmsnorm(p["norm"], x, cfg.norm_eps)
    y, aux = mw.dispatch_virtual(p, h, cfg, n_expert, n_mlp)
    yw, auxw = moe._dispatch(p, h, cfg)
    assert float(aux) == float(auxw)
    if n_mlp == 1:
        np.testing.assert_array_equal(y.numpy(), yw.numpy())
    else:
        np.testing.assert_allclose(y.numpy(), yw.numpy(), rtol=0, atol=TOL)
    yj, auxj = jmoe.moe_apply(jax.tree.map(jnp.asarray, pj),
                              jnp.asarray(z["x"]), jc)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=TOL)
    assert abs(float(aux) - float(auxj)) <= 1e-6


def test_dry_run_shows_both_layouts():
    """A reduced Qwen3-MoE train round on a fake (8, 2) mesh of 16 ranks
    (FSDP rules: the experts over "data", expert_mlp and the vocab over
    "model"): the lookup issues its all-reduce and gathers no table, no
    op is issued by a replicated dispatch, and every expert product of
    the dense dispatch (the eval batches) is a rank's E/8 experts by its
    f/2 columns."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = mw._f32("qwen3-moe-30b-a3b")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        mesh = init_device_mesh("cpu", (8, 2),
                                mesh_dim_names=("data", "model"))
        built = steps.build_step(cfg, InputShape("train", *mw.TRAIN,
                                                 "train"), mesh)
        _, table, _ = dryrun.dry_run(built, mesh, "cpu")
    finally:
        dist.destroy_process_group()
        dryrun.forget_meshes()
    rows = {(r["fn"], r["op"]): r for r in table}
    lookup = {f"models/layers.py:{f}" for f in (
        "embed", "_vocab_parallel", "vocab_shard_lookup", "vocab_shard_grad")}
    assert not [k for k in rows if k[0] in lookup and "all_gather" in k[1]]
    assert any(fn == "models/layers.py:_vocab_parallel" and "all_reduce" in op
               for fn, op in rows)
    assert not [k for k in rows if k[0] == "models/moe.py:_replicated"]
    bmm = rows[("models/moe.py:expert_ffn", "aten.bmm")]
    T = steps.EVAL_BATCH * mw.TRAIN[0]
    per_call = (2 * (cfg.num_experts // 8) * moe.capacity(T, cfg)
                * cfg.d_model * (cfg.d_ff // 2))
    assert bmm["calls"] > 0 and bmm["flops"] == bmm["calls"] * per_call
