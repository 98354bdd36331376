"""The dry-run and its cost model (`launch/dryrun.py`, `op_costmodel.py`,
`op_analysis.py`, `profile.py`) and the kernels' operators they read, on
the CPU.

- Each kernel operator's fake implementation (its shape rule) gives the
  shapes, dtypes and strides of its CPU implementation's outputs
  (`torch.library.opcheck`), launches nothing and counts no launch.
- The sharded-product trap: a (1024 x 2048) @ (2048 x 512) product row-
  sharded over a (4,) fake mesh costs one rank 5.37e8 FLOPs, not the
  global 2.147e9 that `FlopCounterMode` counts over DTensors.
- A reduced SmolLM-360M train round and prefill on a one-rank mesh: the
  fake dry-run's counts (FLOPs, HBM bytes, collectives, arguments, the
  live bytes' peak) equal the same counter's over real CPU tensors.
- The same steps against the reference: `hlo_costmodel.analyze` of the
  compiled HLO on one CPU device. The reference's `chunked_attention`
  (layers.py:129) computes every padded (q chunk, kv chunk) tile; the
  port's flash operators count 4 hd (forward) and 10 hd (backward) a
  visited (query, key) pair. With the reference's attention dots scaled
  to the visited pairs the totals agree within 2% (residuals stated
  below).
- `model_flops_per_device`, `pair_is_applicable` and `roofline` equal
  the reference's (the roofline with the reference's constants set to
  the card's); `profile.attribute` sums to the cost model's totals; the
  record keeps the reference's keys; `--reanalyze` re-derives a record
  from its op table without a trace; no process group outlives
  `run_one`.
"""
import ast
import dataclasses
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import torch_mesh_worker as mw
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import InputShape as JShape
from repro.configs.base import get_arch as jget_arch
from repro.launch import hlo_analysis, hlo_costmodel
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_arch
from repro_torch.configs.base import list_archs
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.pso_update import ops as pops
from repro_torch.kernels.quant_pack import ops as qops
from repro_torch.kernels.rglru_scan import ops as sops
from repro_torch.kernels.wire_agg import ops as wops
from repro_torch.launch import dryrun, op_analysis, op_costmodel, profile
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps

ROOT = Path(__file__).resolve().parents[1]
REF_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"
# the reduced steps held to the reference: (kind, seq, global batch)
REF_STEPS = (("prefill", 64, 4), ("train", 64, 4))
# |port - reference| / reference of the total FLOPs once the reference's
# attention dots count the visited pairs only: the prefill's products are
# the same; the train round adds Eq. 8 (pso_update: 8 operations an
# element, elementwise arithmetic in the reference: 0.28%) and the port's
# attention evaluations (8 forward and 2 backward launches against the
# reference's 6 forward-equivalents of dots: 0.36%)
REF_RESIDUAL = {"prefill": 0.0, "train": 0.0065}


# -- the kernels' operators ------------------------------------------------

def _op_cases():
    g = torch.Generator().manual_seed(0)
    f32, i32 = torch.float32, torch.int32
    x = torch.randn((2, 256, 128), generator=g)
    r = 0.1 * torch.randn((2, 256, 128), generator=g)
    seeds = torch.tensor([3, 7], dtype=i32)
    mask = torch.tensor([1.0, 0.0])
    w = torch.tensor([0.5, 2.0])
    cases = []
    for bits in (8, 4):
        packed, scales = qops.quant_pack_2d(x, seeds, bits=bits)
        cases += [(qops.QUANT_PACK, (x, seeds, bits)),
                  (qops.QUANT_PACK_EF, (x, r, seeds, bits)),
                  (qops.DEQUANT_UNPACK, (packed, scales, bits)),
                  (wops.WIRE_AGG, (packed, scales, mask, w, bits, "mean",
                                   0.1))]
    q = torch.randn((1, 16, 2, 32), generator=g)
    k = torch.randn((1, 16, 1, 32), generator=g)
    v = torch.randn((1, 16, 1, 32), generator=g)
    masks = (True, 4, 0, 16)
    out, lse = fops.FLASH_LSE(q, k, v, *masks)
    cases += [(fops.FLASH, (q, k, v, *masks)),
              (fops.FLASH_LSE, (q, k, v, *masks)),
              (fops.FLASH_BWD, (q, k, v, out, torch.randn_like(out), lse,
                                *masks))]
    a = torch.rand((2, 8, 16), generator=g)
    b = torch.randn((2, 8, 16), generator=g)
    h0 = torch.randn((2, 16), generator=g)
    states = sops.RGLRU_SCAN(h0, a, b)
    cases += [(sops.RGLRU_SCAN, (h0, a, b)),
              (sops.RGLRU_SCAN_BWD, (h0, a, states, torch.randn_like(a)))]
    for dt in (f32, torch.bfloat16):
        w0 = torch.randn((2, 3, 8), generator=g).to(dt)
        co = torch.tensor([[0.5, 1.0, 1.0, 0.0], [0.4, 0.2, 0.3, 0.1]])
        cases.append((pops.PSO_UPDATE, (co, w0, w0 * 0.5, w0 + 1, w0[0],
                                        w0 * 0.1)))
    return cases


def test_every_kernel_is_an_operator():
    """Every launch site is a repro_torch operator with CUDA, CPU and
    fake (Meta) implementations and a cost, which flop_counter reads."""
    from torch.utils.flop_counter import flop_registry
    names = {op.name().split("::")[1] for op, _ in _op_cases()}
    assert names == {"quant_pack", "quant_pack_ef", "dequant_unpack",
                     "wire_agg", "flash_attention", "flash_attention_lse",
                     "flash_attention_bwd", "rglru_scan", "rglru_scan_bwd",
                     "pso_update"}
    for op, args in _op_cases():
        for key in ("CUDA", "CPU", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                op.name(), key), (op, key)
        flops, nbytes = runtime.op_cost(op, *args)
        assert flops > 0 and nbytes > 0
        assert flop_registry[op.overloadpacket](*args) == flops


@pytest.mark.parametrize("case", range(len(_op_cases())),
                         ids=[f"{op.name().split('::')[1]}-{i}"
                              for i, (op, _) in enumerate(_op_cases())])
def test_fake_matches_cpu(case):
    """The shape rule against the plain version: shapes, dtypes, strides
    (opcheck's schema and fake-tensor checks); under FakeTensorMode it
    launches and counts nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args, test_utils=("test_schema",
                                                "test_faketensor"))
    runtime.reset_counts()
    with FakeTensorMode() as fm:
        fargs = [fm.from_tensor(a) if torch.is_tensor(a) else a
                 for a in args]
        fouts = op(*fargs)
    real = op(*args)
    real = real if isinstance(real, tuple) else (real,)
    fouts = fouts if isinstance(fouts, tuple) else (fouts,)
    for f, t in zip(fouts, real):
        # a size-1 dim's stride is free (both are contiguous)
        assert (f.shape, f.dtype, _strides(f)) == (t.shape, t.dtype,
                                                   _strides(t))
    assert runtime.counts() == {}


def test_direct_only_for_plain_cuda_tensors():
    """A wrapper skips the dispatcher only for a plain CUDA tensor with no
    dispatch mode active: CPU, meta and fake tensors (a fake CUDA one
    included) and any mode go through the operator."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    assert not runtime.direct(torch.zeros(2))
    assert not runtime.direct(torch.zeros(2, device="meta"))
    with FakeTensorMode():
        assert not runtime.direct(torch.empty(2, device="cuda"))
    with op_costmodel.OpCostModel():
        assert not runtime.direct(torch.zeros(2))


def _strides(t) -> list:
    return [s for s, n in zip(t.stride(), t.shape) if n > 1]


def test_visited_pairs_match_the_mask():
    from repro_torch.kernels.flash_attention.ref import attention_mask
    for Sq, Sk, causal, window, q_off, kv in ((7, 7, True, 0, 0, 7),
                                              (5, 12, True, 3, 7, 12),
                                              (4, 9, False, 0, 0, 6),
                                              (6, 10, True, 4, 2, 8)):
        want = int(attention_mask(Sq, Sk, causal=causal, window=window,
                                  q_offset=q_off, kv_len=kv,
                                  device="cpu").expand(Sq, Sk).sum())
        assert fops.visited_pairs(Sq, Sk, causal, window, q_off, kv) == want


# -- the cost model on meshes ---------------------------------------------

@pytest.fixture
def fake_group():
    """A fake process group of `world` ranks for the test's duration."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world, rank=0):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()
    dryrun.forget_meshes()


def test_sharded_product_counts_one_rank(fake_group):
    """FlopCounterMode over DTensors counts the global product; the cost
    model counts rank 0's: a quarter, and the all-gather of its rows."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    fake_group(4)
    mesh = init_device_mesh("cpu", (4,))
    with FakeTensorMode() as fm:
        a = DTensor.from_local(torch.empty(256, 2048), mesh, [Shard(0)],
                               run_check=False)
        b = DTensor.from_local(torch.empty(2048, 512), mesh, [Replicate()],
                               run_check=False)
        with FlopCounterMode(display=False) as fc:
            a @ b
        out, cm = op_costmodel.count_step(
            lambda a, b: (a @ b).redistribute(mesh, [Replicate()]), (a, b),
            fake_mode=fm)
    assert fc.get_total_flops() == 2 * 1024 * 2048 * 512 == 2147483648
    assert cm.flops == 2 * 256 * 2048 * 512 == 536870912
    coll = cm.collectives()
    assert coll["by_kind_count"]["all-gather"] == 1
    assert coll["by_kind_bytes"]["all-gather"] == 256 * 512 * 4


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_fake_equals_real_on_one_rank(kind, fake_group):
    """A reduced SmolLM-360M step on a one-rank mesh: the dry-run's
    counts over fake tensors equal the same counter's over real CPU
    tensors, the live bytes' peak included."""
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        real = mw.dryrun_real("smollm-360m", kind, mesh)
    finally:
        dist.destroy_process_group()
        dryrun.forget_meshes()
    fake = mw.dryrun_fake("smollm-360m", kind, (1, 1), 0)
    assert real == fake
    assert real["flops"] > 0 and real["peak_bytes"] > real["argument_bytes"]


def test_fsdp_round_on_a_straddling_mesh(fake_group):
    """What the dry-run of Qwen3-MoE-30B-A3B's train_4k round on the
    16 x 16 mesh found, at a reduced size: an FSDP worker's 2
    microbatches over a 4-way data axis (the chunks straddle the row
    shards), 4 kv heads over an 8-way model axis (the k and v columns
    straddle the heads), and a gradient accumulator that was a whole
    f32 leaf on every rank. The round now traces, and the accumulator is
    laid out as the params (f32: twice their bf16 bytes), not whole."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_group(32)
    mesh = init_device_mesh("cpu", (4, 8), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(),
                              num_heads=8, head_dim=16)
    built = steps.build_step(cfg, InputShape("train", 32, 16, "train"), mesh)
    assert built.meta["dcfg"].microbatches == 2 and cfg.num_kv_heads == 4
    summary, table, _ = dryrun.dry_run(built, mesh, "cpu")
    brk = summary["peak_breakdown"]
    acc = brk["temporaries"]["core/rounds.py:<lambda>"]
    assert acc <= 2 * brk["arguments"]["state.params"]
    assert any(r["op"] == "c10d.alltoall_base_" for r in table)   # EP


# -- against the reference -------------------------------------------------

def _ref_attention_flops(text: str) -> int:
    """The reference's attention dots: those with two batch dims (batch,
    heads: chunked_attention's einsums and their gradients), each
    weighted by its computation's while-trip multiplicity."""
    comps, entry = hlo_costmodel.parse_hlo(text)
    mult, order = {entry: 1}, [entry]
    for name in order:
        for ins in comps[name].instructions:
            kids = []
            if ins.op == "while":
                m = hlo_costmodel._WHILE_REFS.search(ins.rest)
                if m:
                    c, body = m.groups()
                    trips = hlo_costmodel._trip_count(comps[c]) \
                        if c in comps else 1
                    kids = [(c, trips), (body, trips)]
            else:
                kids = [(m.group(1), 1) for m in re.finditer(
                    r"(?:to_apply|calls)=%?([\w\.\-]+)", ins.rest)]
            for child, n in kids:
                if child in comps:
                    mult[child] = mult.get(child, 0) + mult[name] * n
                    if child not in order:
                        order.append(child)
    total = 0
    for name, comp in comps.items():
        symtab = comp.symtab()
        for ins in comp.instructions:
            bm = re.search(r"lhs_batch_dims=\{([\d,]*)\}", ins.rest)
            if ins.op == "dot" and bm and len(
                    [d for d in bm.group(1).split(",") if d]) >= 2:
                total += hlo_costmodel._dot_flops(ins, symtab) * mult.get(
                    name, 0)
    return total


@pytest.fixture(scope="module")
def reference_costs():
    """hlo_costmodel.analyze of the reference's reduced steps, compiled
    on one CPU device, and their attention dots."""
    cfg = jget_arch("smollm-360m").reduced()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    out = {}
    for kind, S, B in REF_STEPS:
        built = jsteps.build_step(cfg, JShape(kind, S, B, kind), mesh)
        ctx = (jax.sharding.use_mesh(mesh)
               if hasattr(jax.sharding, "use_mesh") else mesh)
        with ctx:
            text = built.fn.lower(*built.args).compile().as_text()
        out[kind] = (hlo_costmodel.analyze(text)["flops"],
                     _ref_attention_flops(text))
    return out


@pytest.mark.parametrize("kind,S,B", REF_STEPS)
def test_flops_match_the_reference(kind, S, B, reference_costs, fake_group):
    """Port (fake dry-run, one rank) against the reference's HLO cost
    model on the same reduced step. chunked_attention's single (S, S)
    tile here computes S^2 pairs a head; the port's flash operators
    count the S (S + 1) / 2 causal ones: the reference's attention dots
    are scaled by that ratio, the rest must match as stated."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_group(1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    built = steps.build_step(get_arch("smollm-360m").reduced(),
                             InputShape(kind, S, B, kind), mesh)
    summary, table, _ = dryrun.dry_run(built, mesh, "cpu")
    ref_total, ref_attn = reference_costs[kind]
    visited = S * (S + 1) // 2 / (S * S)
    ref = ref_total - ref_attn + ref_attn * visited
    port_attn = sum(r["flops"] for r in table
                    if r["op"].startswith("repro_torch.flash"))
    rel = abs(summary["flops"] - ref) / ref
    assert rel <= REF_RESIDUAL[kind] + 1e-4 and rel < 0.02, (
        summary["flops"], ref, rel)
    if kind == "prefill":       # the products outside attention: exact
        assert summary["flops"] - port_attn == ref_total - ref_attn


def _ref_functions() -> dict:
    """The reference dry-run's `model_flops_per_device` and
    `pair_is_applicable`, compiled from its source with its own
    `get_arch` (importing the module would set XLA_FLAGS to 512
    devices)."""
    tree = ast.parse(REF_DRYRUN.read_text())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("model_flops_per_device", "pair_is_applicable")]
    ns = {"get_arch": jget_arch}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(REF_DRYRUN),
                 "exec"), ns)
    return ns


def test_model_flops_and_pairs_match_the_reference():
    ref = _ref_functions()
    assert set(INPUT_SHAPES) == set(J_SHAPES)
    for arch in list_archs():
        for name, shape in INPUT_SHAPES.items():
            for n_dev in (256, 512):
                assert dryrun.model_flops_per_device(
                    get_arch(arch), shape, n_dev) == \
                    ref["model_flops_per_device"](jget_arch(arch),
                                                  J_SHAPES[name], n_dev)
            assert dryrun.pair_is_applicable(arch, name) == \
                ref["pair_is_applicable"](arch, name)


@pytest.mark.parametrize("args", [(1e15, 2e12, 3e10, 4e14, False),
                                  (3e12, 9e12, 0.0, 1e12, True),
                                  (0, 1e9, 1e9, 0.0, False)])
def test_roofline_matches_the_reference(args, monkeypatch):
    monkeypatch.setattr(jmesh, "PEAK_FLOPS_BF16", pmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jmesh, "HBM_BW", pmesh.HBM_BW)
    monkeypatch.setattr(jmesh, "ICI_BW", pmesh.NVLINK_BW)
    *head, fma = args
    assert op_analysis.roofline(*head, fma_counted=fma) == \
        hlo_analysis.roofline(*head, fma_counted=fma)


# -- the record, the profiler, the process group ---------------------------

# the reference record's keys (dryrun.py:95-123) and their counterparts
REF_KEYS = {"arch", "shape", "mesh", "algorithm", "devices", "ok", "tag",
            "memory", "flops_per_device", "hbm_bytes_per_device",
            "collectives", "roofline", "meta", "total_s"}
COUNTERPARTS = {"lower_s": "trace_s", "compile_s": "trace_s",
                "hlo_path": "ops_path"}


def test_run_one_record_profile_and_reanalyze(tmp_path, monkeypatch):
    """A full-width decode dry-run on the 256-rank fake mesh: the
    record's keys, the profiler's sums, a re-analysis from the op table
    alone, and no process group left behind (also after a failure)."""
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", tmp_path)
    rec = dryrun.run_one("smollm-360m", "decode_32k", "single")
    assert not dist.is_initialized()
    assert rec["ok"], rec.get("traceback")
    assert REF_KEYS | set(COUNTERPARTS.values()) <= set(rec)
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    assert rec["devices"] == 256 and rec["collectives"]["total_bytes"] > 0
    table = profile.load(rec["ops_path"])
    for term, total in (("memory", rec["hbm_bytes_per_device"]),
                        ("flops", rec["flops_per_device"]),
                        ("collective", rec["collectives"]["total_bytes"])):
        rows = profile.attribute(table, term)
        assert sum(v for v, _, _ in rows) == total
        assert [v for v, _, _ in rows] == sorted((v for v, _, _ in rows),
                                                 reverse=True)
    path = dryrun.artifact_path("smollm-360m", "decode_32k", "single")
    kept = dict(rec)
    rec.update(flops_per_device=0, roofline={})
    path.write_text(json.dumps(rec))

    def no_trace(*a, **k):
        raise AssertionError("reanalyze traced")
    monkeypatch.setattr(dryrun, "dry_run", no_trace)
    dryrun.reanalyze_all()
    again = json.loads(path.read_text())
    for key in ("flops_per_device", "hbm_bytes_per_device", "collectives",
                "roofline"):
        assert again[key] == kept[key], key
    # a failure is recorded, and the group is gone too
    monkeypatch.setattr(dryrun, "build_step", no_trace)
    bad = dryrun.run_one("smollm-360m", "decode_32k", "single",
                         save_ops=False)
    assert not bad["ok"] and "reanalyze traced" in bad["error"]
    assert bad["traceback"] and not dist.is_initialized()
