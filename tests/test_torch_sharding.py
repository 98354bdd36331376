"""The port's sharding rules and specs (`sharding/*`, `launch/steps`'
layouts and input specs, `core/population.table_specs`) against the JAX
package's, exactly: no process group, no device.

The meshes are stand-ins with `shape` and `axis_names`, as
tests/test_sharding.py uses: the production (16, 16) ("data", "model")
mesh and the (2, 16, 16) ("pod", "data", "model") one. For every config
in `configs/` and every rule table (the four canonical ones, the serve
rules with and without long context, the train rules), the port's
`spec_for_path` equals the reference's for every parameter leaf (paths
and shapes from `jax.eval_shape(model.init)` against the port's meta
init) and every serve-cache leaf; the worker-stacked train state's specs
equal the reference's `tree_shardings` with the worker prefix.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import get_arch as jget_arch
from repro.core import population as jpop
from repro.launch import steps as jsteps
from repro.models.transformer import Transformer as JTransformer
from repro.sharding import param_specs as jps
from repro.sharding import rules as jrules
from repro_torch.comm.budget import CommConfig
from repro_torch.configs.base import ArchConfig, InputShape, list_archs
from repro_torch.core import population as ppop
from repro_torch.launch import steps
from repro_torch.models.transformer import Transformer
from repro_torch.pytree import tree_leaves, tree_leaves_with_path
from repro_torch.sharding import param_specs as ps
from repro_torch.sharding import rules


class Mesh2:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class Mesh3:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


MESHES = {"16x16": Mesh2, "2x16x16": Mesh3}
TABLES = ["UNSHARDED", "SINGLE_POD_TP", "SINGLE_POD_FSDP_TP",
          "MULTI_POD_TP", "MULTI_POD_FSDP_TP"]
DERIVED = ["serve", "serve_long", "train"]
ARCHS = list_archs()


def _tables(mesh_name):
    """The rule tables that fit the mesh: the multi-pod ones name "pod"."""
    return [t for t in TABLES + DERIVED
            if mesh_name == "2x16x16" or not t.startswith("MULTI")]


def _rule_pair(table, jcfg, pcfg, mesh):
    if table == "serve":
        return (jsteps.serve_rules(jcfg, mesh, False),
                steps.serve_rules(pcfg, mesh, False))
    if table == "serve_long":
        return (jsteps.serve_rules(jcfg, mesh, True),
                steps.serve_rules(pcfg, mesh, True))
    if table == "train":
        return jsteps.train_rules(jcfg, mesh), steps.train_rules(pcfg, mesh)
    return getattr(jrules, table), getattr(rules, table)


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    j = jsteps._prep_cfg(jget_arch(arch))
    return j, ArchConfig(**dataclasses.asdict(j))


def _jpaths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(jps._path_str(p), tuple(np.shape(x))) for p, x in flat]


def _ppaths(tree):
    return [(ps._path_str(p), tuple(x.shape) if hasattr(x, "shape") else ())
            for p, x in tree_leaves_with_path(tree)]


@functools.lru_cache(maxsize=None)
def _param_paths(arch):
    jc, pc = _cfgs(arch)
    want = _jpaths(jax.eval_shape(JTransformer(jc).init,
                                  jax.random.PRNGKey(0)))
    got = _ppaths(Transformer(pc).init(None, "meta"))
    return want, got


@functools.lru_cache(maxsize=None)
def _cache_paths(arch):
    jc, pc = _cfgs(arch)
    want = _jpaths(jsteps._serve_cache_shapes(JTransformer(jc), jc, 128,
                                              32768))
    got = _ppaths(steps._serve_cache_shapes(Transformer(pc), pc, 128, 32768))
    return want, got


def test_rule_tables_match_reference():
    for t in TABLES:
        assert dict(getattr(rules, t)) == dict(getattr(jrules, t)), t
        assert isinstance(getattr(rules, t), rules.ShardingRules)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_reference(arch, mesh_name):
    """Every parameter and serve-cache leaf, every rule table that fits
    the mesh: the port's spec is the reference's PartitionSpec, entry for
    entry."""
    mesh = MESHES[mesh_name]()
    jc, pc = _cfgs(arch)
    pw, pg = _param_paths(arch)
    cw, cg = _cache_paths(arch)
    assert pg == pw
    # the port's cache `pos` is one host int where the reference keeps a
    # (n_rep,) array (ROADMAP's known differences): paths equal, shapes
    # equal but for those
    assert [p for p, _ in cg] == [p for p, _ in cw]
    assert all(g == w for (p, g), (_, w) in zip(cg, cw)
               if not p.endswith("/pos"))
    for table in _tables(mesh_name):
        jr, pr = _rule_pair(table, jc, pc, mesh)
        assert dict(pr) == dict(jr), table
        for kind, leaves in (("param", pw), ("cache", cw)):
            for path, shape in leaves:
                want = jps.spec_for_path(path, shape, jr, mesh, kind)
                got = ps.spec_for_path(path, shape, pr, mesh, kind)
                assert got == tuple(want), (table, kind, path, shape)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_worker_stacked_state_specs_match_reference(arch, mesh_name):
    """The train state's (W, ...) leaves: the worker prefix resolved with
    the rest, as the reference's `tree_shardings(prefix_axes=1)`; and the
    swarm layout and train rules."""
    mesh = MESHES[mesh_name]()
    jc, pc = _cfgs(arch)
    axes, W = steps.swarm_layout(pc, mesh)
    assert (axes, W) == jsteps.swarm_layout(jc, mesh)
    wspec = (axes if len(axes) != 1 else axes[0]) if axes else None
    jr, pr = jsteps.train_rules(jc, mesh), steps.train_rules(pc, mesh)
    jshapes = jax.eval_shape(JTransformer(jc).init, jax.random.PRNGKey(0))
    jstack = jax.tree.map(lambda x: jax.ShapeDtypeStruct((W,) + x.shape,
                                                         x.dtype), jshapes)
    pstack = Transformer(pc).init(None, "meta")
    flat = jax.tree_util.tree_flatten_with_path(jstack)[0]
    got = tree_leaves(ps.tree_shardings(
        _stack_meta(pstack, W), pr, mesh, prefix_axes=1,
        prefix_spec=(wspec,)))
    assert len(got) == len(flat)
    for (path, x), lay in zip(flat, got):
        spec = jps.spec_for_path(jps._path_str(path), x.shape[1:], jr, mesh)
        want = jps._dedup_and_divide(tuple((wspec,)) + tuple(spec) + (None,)
                                     * (len(x.shape) - 1 - len(spec)),
                                     x.shape, jr, mesh)
        assert lay.spec == tuple(want), jps._path_str(path)


def _stack_meta(tree, W):
    import torch
    from repro_torch.pytree import tree_map
    return tree_map(lambda x: torch.empty((W,) + tuple(x.shape),
                                          dtype=x.dtype, device="meta"), tree)


_DTYPES = {"int32": "int32", "uint32": "uint32", "bfloat16": "bfloat16",
           "float32": "float32"}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]()
    jc, pc = _cfgs(arch)
    for name, shape in J_SHAPES.items():
        want = jsteps.input_specs(jc, shape, mesh)
        got = steps.input_specs(pc, InputShape(**dataclasses.asdict(shape)),
                                mesh)
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        gl = tree_leaves_with_path(got)
        assert [jps._path_str(p) for p, _ in wl] == [
            ps._path_str(p) for p, _ in gl], name
        for (_, w), (_, g) in zip(wl, gl):
            assert tuple(g.shape) == tuple(w.shape), name
            assert str(g.dtype).removeprefix("torch.") == _DTYPES[
                str(w.dtype)], name
            assert g.device.type == "meta"


@pytest.mark.parametrize("population", [1_000, 1_000_000])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_population_specs_match_reference(mesh_name, population):
    """`table_specs` leaf for leaf (meta tensors against the reference's
    ShapeDtypeStructs) and `population_specs`' pricing over the worker
    axes."""
    mesh = MESHES[mesh_name]()
    want = jax.tree.leaves(jpop.table_specs(population))
    got = tree_leaves(ppop.table_specs(population))
    assert [(tuple(w.shape), str(w.dtype)) for w in want] == [
        (tuple(g.shape), str(g.dtype).removeprefix("torch.")) for g in got]
    assert all(g.device.type == "meta" for g in got)
    axes, W = steps.swarm_layout(_cfgs("smollm-360m")[1], mesh)
    specs, lays, meta = steps.population_specs(CommConfig(), population,
                                               mesh, axes)
    total = sum(int(np.prod(w.shape)) * w.dtype.itemsize for w in want)
    assert meta == {"population": population, "table_bytes": total,
                    "bytes_per_shard": total // W, "worker_axes": axes}
    wspec = axes if len(axes) != 1 else axes[0]
    assert all(lay.spec == (wspec,) for lay in tree_leaves(lays))


def test_train_step_meta_prices_population():
    mesh = Mesh2()
    built = steps.build_train_step(_cfgs("smollm-360m")[1],
                                   InputShape("t", 4096, 256, "train"), mesh,
                                   comm=CommConfig(), population=10_000)
    assert built.meta["W"] == 16 and built.meta["worker_axes"] == ("data",)
    assert built.meta["population_table_bytes"] == 36 * 10_000
    assert built.meta["population_bytes_per_shard"] == 36 * 10_000 // 16


# --- the reference's tests/test_sharding.py cases -------------------------

SPEC_CASES = [
    # (rules, names, expected)
    ("SINGLE_POD_TP", ("batch", "seq", "heads"), (None, None, "model")),
    # expert takes "data", so embed_fsdp (also "data") is dropped
    ("SINGLE_POD_FSDP_TP", ("expert", "embed_fsdp", "expert_mlp"),
     ("data", None, "model")),
    ("SINGLE_POD_TP", ("nonexistent",), (None,)),
]


@pytest.mark.parametrize("table,names,want", SPEC_CASES)
def test_rules_spec_cases(table, names, want):
    got = getattr(rules, table).spec(names)
    assert got == want == tuple(getattr(jrules, table).spec(names))


PATH_CASES = [
    # 15 heads on a 16-way model axis: replicated
    ("groups/b0/temporal/wq", (960, 15, 64), "SINGLE_POD_TP", "param",
     (None, None, None)),
    ("groups/b0/mlp/wi", (960, 2560), "SINGLE_POD_TP", "param",
     (None, "model")),
    ("groups/b0/moe/wi", (2, 128, 2048, 768), "SINGLE_POD_FSDP_TP", "param",
     (None, "data", None, "model")),
    # kv 16 divides the model axis: a head-sharded cache
    ("groups/b0/temporal/k", (16, 128, 32768, 16, 128),
     "SINGLE_POD_FSDP_TP", "cache", (None, "data", None, "model", None)),
    # kv 8 does not: dropped (serve_rules seq-shards the cache instead)
    ("groups/b0/temporal/k", (16, 128, 32768, 8, 128),
     "SINGLE_POD_FSDP_TP", "cache", (None, "data", None, None, None)),
]


@pytest.mark.parametrize("path,shape,table,kind,want", PATH_CASES)
def test_spec_for_path_cases(path, shape, table, kind, want):
    mesh = Mesh2()
    got = ps.spec_for_path(path, shape, getattr(rules, table), mesh, kind)
    assert got == want == tuple(jps.spec_for_path(
        path, shape, getattr(jrules, table), mesh, kind))


def test_placements_from_spec():
    """Shard(dim) on each mesh dim a tensor dim names (a tuple of axes
    shards one dim over several, mesh order), Replicate() elsewhere, and
    a size-1 axis replicates."""
    from torch.distributed.tensor import Replicate, Shard
    m3 = Mesh3()
    assert rules.placements((("pod", "data"), None, "model"), m3) == (
        Shard(0), Shard(0), Shard(2))
    assert rules.placements((None, "model"), Mesh2()) == (Replicate(),
                                                           Shard(1))

    class One:
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")
    assert rules.placements(("data", "model"), One()) == (Replicate(),
                                                          Shard(1))


def test_shard_is_a_noop_off_the_mesh():
    import torch
    x = torch.ones(4, 8)
    assert rules.shard(x, ("batch", "embed")) is x
    with rules.use_rules(rules.SINGLE_POD_TP, Mesh2()):
        assert rules.shard(x, ("batch", "embed")) is x   # a plain tensor
        assert rules.logical_to_spec(("heads",)) == ("model",)
    assert rules.get_rules() == (None, None)
    assert rules.logical_to_spec(("heads",)) is None


def test_rules_are_seen_from_other_threads():
    """The active rules are process-wide: on a card autograd runs the
    backward, and checkpoint's recompute of a layer group, on its own
    thread, whose `shard()` calls must see the rules of the forward."""
    import threading
    seen = []
    with rules.use_rules(rules.SINGLE_POD_TP, Mesh2()):
        t = threading.Thread(target=lambda: seen.append(rules.get_rules()))
        t.start()
        t.join()
    assert seen[0][0] is rules.SINGLE_POD_TP
    assert rules.get_rules() == (None, None)
