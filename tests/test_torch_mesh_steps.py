"""`launch/steps.build_step` on CPU meshes of spawned gloo ranks: one
M-DSL round (train), a prefill and two decode steps of reduced
smollm-360m (tp: the workers over "data"), qwen3-moe-30b-a3b (fsdp: the
batch over "data", E 8 top 2 dropless, so the all-to-all EP dispatch
runs) and recurrentgemma-9b (RG-LRU scan, one kv head: a sequence-
sharded serve cache on "model"), in f32, at the reference mini-mesh's
shapes (train seq 128 x batch 8, decode a cache of 256 x batch 8, and a
64-token prefill of batch 8).

Each sharded result equals the same step with no mesh (the port's
one-process `swarm_dist` round and `Transformer` prefill / decode on the
same inputs and draws): meshes (2, 1) (worker or data parallel), (1, 2)
(tensor parallel) and (2, 2) (both). On a (1, 1) mesh the step is
bitwise the one-process one. The one-process round equals the
reference's unsharded round given the reference's draws (here for the
EP config; tests/test_torch_swarm_dist.py holds the same round function
to the reference for smollm and recurrentgemma), and the serve steps
the reference's prefill and decode (the reference cannot run as a
multi-device oracle on jax 0.9: ROADMAP).

Tolerances (f32): sharded against one process, bitwise where only
workers or whole sequences shard (the round and the prefill of smollm
and recurrentgemma on (2, 1)); elsewhere the tensor-parallel products,
the EP aux sum and a decode step's half-batch products (a GEMM of 4 rows
where one process runs 8 rounds otherwise) in other orders: params and
logits within 1e-6 max abs, losses within 2e-6, selection masks exact.
Against the reference: LOSS_TOL / PARAM_TOL of tests/test_torch_swarm_dist.py
for the round, logits within 5e-4 with equal greedy tokens (ROADMAP's f32
serve parity).
"""
import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as mw
from repro.configs.base import get_arch as jget_arch
from repro.core import swarm_dist as jswarm
from repro.launch import steps as jsteps
from repro.models.transformer import Transformer as JTransformer
from repro_torch import bridge
from test_torch_swarm_dist import LOSS_TOL, PARAM_TOL, jax_dist_draws

ARCHS = ["smollm-360m", "qwen3-moe-30b-a3b", "recurrentgemma-9b"]
KINDS = ["train", "prefill", "decode"]
MESHES = {"2x1": (2, 1), "1x2": (1, 2)}
TOL, LOSS = 1e-6, 2e-6
NAMES = ("data", "model")


def _W(arch, mesh_shape):
    return mesh_shape[0] if arch != "qwen3-moe-30b-a3b" else 1


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """Two ranks running the (2, 1) and then the (1, 2) mesh, started
    with the module's first test (the reference comparisons, first in the
    file, run while they work); the (2, 2) case's four ranks start when
    they are done (`sharded`), so that no more than four ranks run at
    once beside the test workers."""
    d = tmp_path_factory.mktemp("mesh_steps")
    inputs = str(d / "in.npz")
    # FedAvg, the packed (int8) and straggler (deadline) wires and the
    # kernel boundary on the (2, 1) mesh only
    np.savez(inputs, archs=np.array(ARCHS), kinds=np.array(KINDS + ["init"]),
             **{"2x1:extra": np.array([["smollm-360m", "fedavg"],
                                       ["smollm-360m", "int8"],
                                       ["smollm-360m", "deadline"]]),
                "2x1:boundary_seed": np.array(24)})
    np.savez(str(d / "in22.npz"), archs=np.array(["smollm-360m"]),
             kinds=np.array(["train"]))
    handles = {"two": mw.start("mesh_steps", [MESHES[m] for m in
                                              sorted(MESHES, reverse=True)],
                               NAMES, str(d / "two.npz"), inputs,
                               timeout_s=400),
               "dir": d}
    yield handles
    for h in handles.values():
        if isinstance(h, tuple):
            for p in h[0].processes:
                if p.is_alive():
                    p.terminate()


@pytest.fixture(scope="module")
def sharded(launched):
    """Rank 0's results of every (arch, kind) on each mesh, and of the
    (2, 2) case."""
    two = mw.wait(launched["two"])
    d = launched["dir"]
    launched["four"] = mw.start("mesh_steps", (2, 2), NAMES,
                                str(d / "four.npz"), str(d / "in22.npz"),
                                timeout_s=300)
    out = {m: {k.split("/", 1)[1]: v for k, v in two.items()
               if k.startswith(m + "/")} for m in MESHES}
    out["2x2"] = mw.wait(launched["four"])
    return out


@pytest.fixture(scope="module")
def one_process():
    cache = {}

    def get(arch, kind, W):
        if (arch, kind, W) not in cache:
            cache[(arch, kind, W)] = mw.one_rank(arch, kind, W)
        return cache[(arch, kind, W)]
    return get


def _compare(got: dict, want: dict, exact: bool, what: str):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k)
        if exact or k == "mask":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            tol = LOSS if k in ("losses", "theta", "global_loss") else TOL
            np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                       err_msg=f"{what} {k}")


def _jcfg(arch):
    c = jsteps._prep_cfg(dataclasses.replace(jget_arch(arch).reduced(),
                                             dtype="float32"))
    if arch.startswith("qwen3"):
        c = dataclasses.replace(c, num_experts=8, experts_per_token=2,
                                moe_capacity_factor=4.0)
    return c


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b"])
def test_one_process_round_matches_reference(arch):
    """The one-process round (as the (2, 1) mesh's W) against the
    reference's unsharded `swarm_dist` round on the same params and
    batches, given the reference's draws: the EP config (E 8, K 2,
    dropless), which tests/test_torch_swarm_dist.py's rounds (the same
    round function; reduced qwen3 at cf 1.25, smollm and recurrentgemma
    at these configs) do not cover."""
    W = _W(arch, (2, 1))
    cfg, model, params, (batch, ev, _) = mw._inputs(arch, "train", W)
    jc = _jcfg(arch)
    jm = JTransformer(jc)
    jp = jax.tree.map(jnp.asarray, bridge.tree_to_numpy(params))
    jcfg = jswarm.DistSwarmConfig(worker_axes=(), num_spatial=W)
    key = jax.random.PRNGKey(5)
    js, ji = jax.jit(jswarm.build_train_step(jm.loss, jcfg))(
        jswarm.init_state(jp, jcfg),
        {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in
         batch.items()},
        {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in ev.items()},
        key)
    got = mw.one_rank(arch, "train", W,
                      draws=jax_dist_draws(key, jcfg.comm, jp, W, "mdsl"))
    np.testing.assert_array_equal(got["mask"], np.asarray(ji.mask))
    for k in ("losses", "theta", "global_loss"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(ji, k)),
                                   rtol=0, atol=LOSS_TOL, err_msg=k)
    for i, w in enumerate(jax.tree.leaves(js.global_params)):
        np.testing.assert_allclose(got[f"global{i}"], np.asarray(w), rtol=0,
                                   atol=PARAM_TOL, err_msg=f"global {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_serve_matches_reference(arch):
    """Prefill and two decode steps against the reference's, on the same
    params, prompt and tokens."""
    jc = _jcfg(arch)
    jm = JTransformer(jc)
    for kind in ("prefill", "decode"):
        cfg, model, params, rest = mw._inputs(arch, kind)
        jp = jax.tree.map(jnp.asarray, bridge.tree_to_numpy(params))
        got = mw.one_rank(arch, kind)
        if kind == "prefill":
            toks = rest[0]["tokens"].numpy().astype(np.int32)
            S, B = mw.PREFILL
            want = {"logits": jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                                         jm.init_cache(B, S))[0]}
        else:
            S, B = mw.DECODE
            _, _, _, (t1, t2, _) = cfg, model, params, rest
            gen = torch.Generator().manual_seed(0)
            model.init(gen, "cpu")
            toks = torch.randint(0, cfg.vocab_size, (B, mw.PROMPT + 2),
                                 generator=gen).numpy().astype(np.int32)
            _, c = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :mw.PROMPT])},
                              jm.init_cache(B, S))
            l1, c = jm.decode_step(jp, jnp.asarray(toks[:, mw.PROMPT:
                                                        mw.PROMPT + 1]), c)
            l2, _ = jm.decode_step(jp, jnp.asarray(toks[:, mw.PROMPT + 1:]),
                                   c)
            want = {"logits1": l1, "logits2": l2}
        for k, w in want.items():
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(got[k], w, rtol=0, atol=5e-4,
                                       err_msg=f"{arch} {kind} {k}")
            np.testing.assert_array_equal(got[k].argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_step_matches_one_process(sharded, one_process, mesh, arch,
                                          kind):
    shape = MESHES[mesh]
    W = _W(arch, shape) if kind == "train" else 1
    got = {k.split("|", 2)[2]: v for k, v in sharded[mesh].items()
           if k.startswith(f"{arch}|{kind}|")}
    exact = (mesh == "2x1" and arch != "qwen3-moe-30b-a3b"
             and kind != "decode")
    _compare(got, one_process(arch, kind, W), exact, f"{mesh} {arch} {kind}")


def test_two_by_two_round_matches_one_process(sharded, one_process):
    got = {k.split("|", 2)[2]: v for k, v in sharded["2x2"].items()}
    _compare(got, one_process("smollm-360m", "train", 2), False, "2x2")


def test_one_rank_mesh_is_bitwise_one_process(tmp_path, one_process):
    """build_step on a (1, 1) mesh of this process: every placement is
    the whole tensor, so the round, the prefill and the decode steps are
    the one-process ones bit for bit (kernel boundary included)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=NAMES)
        for kind in KINDS:
            got = mw.run_step("smollm-360m", kind, mesh)
            _compare(got, one_process("smollm-360m", kind, 1), True,
                     f"1x1 {kind}")
    finally:
        dist.destroy_process_group()


BOUNDARY = {
    # kernel: (layouts run on the shards, layouts gathered first)
    "flash": (("batch", "heads"), ("seq",)),
    "scan": (("batch", "channel"), ("seq",)),
    "pso": (("workers", "rows"), ("partial",)),
    "wire": (("workers",), ("rows",)),
}


@pytest.mark.parametrize("kernel", sorted(BOUNDARY))
def test_kernel_boundary_on_dtensors(sharded, kernel):
    """A wrapper handed DTensors (2 gloo ranks): on the shards where the
    layout allows, gathered to Replicate() first (and counted) where it
    does not; either way the one-process answer. The quantize-pack
    payloads, scales, residuals, decodes and the aggregate bitwise; the
    scan and Eq. 8 bitwise (elementwise over rows and channels); flash
    within TOL (a shard's products are smaller)."""
    res = {k.split("|", 1)[1]: v for k, v in sharded["2x1"].items()
           if k.startswith("boundary|")}
    want = res[f"{kernel}_want"]
    local, gathered = BOUNDARY[kernel]
    for name in local + gathered:
        got = res[f"{kernel}_{name}"]
        if kernel == "flash":
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    counts = dict(zip(res["counts_names"].tolist(), res["counts"].tolist()))
    # one counted call per gathered layout (the decode of gathered
    # payloads has nothing left to gather); wire_agg always gathers
    want_counts = {"flash_attention": 1, "rglru_scan": 1, "pso_update": 1,
                   "quant_pack_ef": 1, "dequant_unpack": 0, "wire_agg": 2}
    names = {"flash": ["flash_attention"], "scan": ["rglru_scan"],
             "pso": ["pso_update"],
             "wire": ["quant_pack_ef", "dequant_unpack", "wire_agg"]}
    for n in names[kernel]:
        assert counts.get(n, 0) == want_counts[n], (n, counts)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_init_placed_draws_only_the_shards(sharded, mesh, arch):
    """`steps.init_placed` on the serve layouts, and `init_placed` then
    `init_state_placed` on the train layouts: each rank holds only its
    slice of a sharded leaf (half the leaf or less here), and the leaves
    are the whole draw's (the whole `init_state`'s) bit for bit; on
    (1, 2) the serve layouts shard."""
    res = {k.split("|", 2)[2]: v for k, v in sharded[mesh].items()
           if k.startswith(f"{arch}|init|")}
    assert float(res["diff"]) == 0.0
    assert bool(res["smaller"])
    if mesh == "1x2":
        assert int(res["sharded"]) > 0


def test_sharded_fedavg_round_matches_one_process(sharded, one_process):
    """`build_step(algorithm="fedavg")`: the baseline's round on the
    (2, 1) mesh (every worker's plain-SGD delta from the global model,
    the same wire) equals the one-process FedAvg round, bitwise."""
    got = {k.split("|", 2)[2]: v for k, v in sharded["2x1"].items()
           if k.startswith("smollm-360m|fedavg|")}
    _compare(got, one_process("smollm-360m", "fedavg", 2), True,
             "2x1 fedavg")


@pytest.mark.parametrize("wire", ["int8", "deadline"])
def test_sharded_wire_routes_match_one_process(sharded, one_process, wire):
    """The other two wire routes on the (2, 1) mesh: int8 takes the
    packed route (quantize-pack with error feedback on each rank's
    workers, `wire_agg` over the gathered payloads), a deadline the
    straggler route (the last worker's delta parked in the buffer). Each
    is bitwise the one-process round."""
    got = {k.split("|", 2)[2]: v for k, v in sharded["2x1"].items()
           if k.startswith(f"smollm-360m|{wire}|")}
    _compare(got, one_process("smollm-360m", wire, 2), True, f"2x1 {wire}")


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in sorted(MESHES)
                                       for a in ARCHS]
                         + [("2x2", "smollm-360m")])
def test_round_wire_holds_no_whole_sharded_leaf(sharded, mesh, arch):
    """No tensor that the round's wire makes on a rank is larger than the
    rank's rows of a (W, ...) leaf gathered over the worker axes: the
    aggregate runs on the model shards, and the global model and the PS
    residual stay sharded. Where the layout shards a leaf along a model
    dim (tensor parallel on "model", or FSDP), that bound is below the
    whole leaf, so no rank held a whole sharded leaf."""
    res = {k.split("|", 2)[2]: v for k, v in sharded[mesh].items()
           if k.startswith(f"{arch}|train|")}
    most, bound = int(res["wire_most"]), int(res["wire_bound"])
    assert 0 < most <= bound, (most, bound)
    if mesh != "2x1":
        assert bound < int(res["whole_leaf"]), (bound, res["whole_leaf"])
