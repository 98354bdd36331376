"""bench/costs, the frozen yardstick: the model FLOP formulas equal
torch.utils.flop_counter on the plain references at a small size, and
every kernel's operations and bytes equal the port's own cost definition
(`runtime.op_cost`) at every cell's launch shapes."""
import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import generator, harness
from bench.costs import cnn5 as cnn5_cost
from bench.costs import transformer as tf_cost
from bench.reference import cnn5, transformer
from bench.reference.tree import leaves, tmap
from bench.tests import tiny


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("C", [1, 3])
def test_cnn5_flops(C):
    """Forward at C workers; the backward at one worker, since the flop
    counter counts a grouped convolution's weight gradient `groups`
    times over (its formula ignores the groups)."""
    cfg = harness.load_json("configs", "cnn5-w8-mnist")
    dims = (cfg["height"], cfg["width"], cfg["channels"], cfg["num_classes"],
            cfg["width_mult"])
    p = tmap(lambda x: x.expand((C,) + tuple(x.shape)).clone(),
             generator.cnn5_params(cfg, 0, "cpu"))
    x = torch.randn(C, 5, 28, 28, 1)
    y = torch.randint(0, 10, (C, 5))
    assert _count(lambda: cnn5.apply(p, x)) == 5 * C * \
        cnn5_cost.forward_flops(*dims)
    if C == 1:
        assert _count(lambda: cnn5.grads(p, x, y)) == 5 * \
            cnn5_cost.train_flops(*dims)


def test_transformer_flops():
    cfg = tiny.mesh()["config"]
    p = generator.transformer_params(cfg, 0, "cpu")
    tok = torch.randint(0, cfg["vocab_size"], (2, 16))
    lab = torch.roll(tok, -1, -1)
    assert _count(lambda: transformer.ce_sum(p, tok, lab, cfg)) == \
        tf_cost.forward_flops(cfg, 2, 16)
    flat = [t.requires_grad_() for t in leaves(p)]

    def train():
        torch.autograd.grad(transformer.ce_sum(p, tok, lab, cfg), flat)
    assert _count(train) == tf_cost.train_flops(cfg, 2, 16)


def _cells():
    bm = harness.benchmark()
    return [w["name"] for w in bm["workloads"]]


@pytest.mark.parametrize("name", _cells())
def test_kernel_costs_match_port(name):
    from repro_torch.kernels import runtime
    importlib.import_module("repro_torch.kernels.quant_pack.ops")
    importlib.import_module("repro_torch.kernels.wire_agg.ops")
    importlib.import_module("repro_torch.kernels.pso_update.ops")
    importlib.import_module("repro_torch.kernels.flash_attention.ops")
    cell = harness.load_json("workloads", name)
    cfg = harness.load_json("configs", cell["config"])
    mix = cell["traffic"]
    eng = importlib.import_module(f"bench.engines.{cell['engine']}").Engine(
        cell, cfg, 0, "cpu")
    ops = torch.ops.repro_torch
    meta = dict(device="meta")
    if cell["engine"] == "paper":
        from bench.costs.quant_pack import padded_rows
        eng.init = generator.cnn5_params(cfg, 0, "cpu")
        plan = eng.launches()
        C = mix["workers"]
        up = int(cell["algorithm"]["uplink"][3:])
        down = int(cell["algorithm"]["downlink"][3:])
        rows = [padded_rows(x.numel()) for x in leaves(eng.init)]
        for r, got in zip(rows, plan["quant_pack_ef"]):
            x = torch.empty(C, r, 128, **meta)
            s = torch.empty(C, dtype=torch.int32, **meta)
            assert got[:2] == runtime.op_cost(ops.quant_pack_ef.default, x, x,
                                              s, up)
        for r, got in zip(rows, plan["wire_agg"]):
            pk = torch.empty(C, r // (8 // up), 128, dtype=torch.uint8, **meta)
            sc = torch.empty(C, r // 256, **meta)
            m = torch.empty(C, **meta)
            assert got[:2] == runtime.op_cost(ops.wire_agg.default, pk, sc, m,
                                              m, up, "mean", 0.1)
        for r, got in zip(rows, plan["quant_pack"]):
            x = torch.empty(1, r, 128, **meta)
            s = torch.empty(1, dtype=torch.int32, **meta)
            assert got[:2] == runtime.op_cost(ops.quant_pack.default, x, s,
                                              down)
        for r, got in zip(rows, plan["dequant_unpack"]):
            pk = torch.empty(1, r, 128, dtype=torch.int8, **meta)
            sc = torch.empty(1, r // 256, **meta)
            assert got[:2] == runtime.op_cost(ops.dequant_unpack.default, pk,
                                              sc, down)
    else:
        plan = eng.launches()
        W, B, S = mix["workers"], mix["batch"], mix["seq_len"]
        H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = cfg["hidden_size"] // H
        bf = dict(dtype=torch.bfloat16, **meta)
        q = torch.empty(B, S, H, hd, **bf)
        k = torch.empty(B, S, K, hd, **bf)
        lse = torch.empty(B, H, S, **meta)
        want = {runtime.op_cost(ops.flash_attention_lse.default, q, k, k,
                                True, 0, None, None),
                runtime.op_cost(ops.flash_attention.default, q, k, k, True,
                                0, None, None)}
        assert {g[:2] for g in plan["flash_attention"]} == want
        assert {g[:2] for g in plan["flash_attention_bwd"]} == {
            runtime.op_cost(ops.flash_attention_bwd.default, q, k, k, q, q,
                            lse, True, 0, None, None)}
        coefs = torch.empty(W, 4, **meta)
        for (shape, dt), got in zip(generator.transformer_shapes(cfg).values(),
                                    plan["pso_update"]):
            w = torch.empty((W,) + shape, dtype=getattr(torch, dt), **meta)
            g = torch.empty(shape, dtype=getattr(torch, dt), **meta)
            assert got[:2] == runtime.op_cost(ops.pso_update.default, coefs,
                                              w, w, w, g, w)
