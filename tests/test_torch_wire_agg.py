"""The port's wire_agg plain version against the JAX ref.

Tolerances: `median` is bitwise. `mean`, `sum` and `trimmed_mean` sum in
a fixed order in the port (worker order; sorted order) where XLA picks
its own reduction order, so they agree to SUM_RTOL * sum|terms| — a
few f32 roundings over at most C terms.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wire_agg import ops as jops
from repro.kernels.wire_agg import ref as jref
from repro_torch.kernels.quant_pack import ref as qref
from repro_torch.kernels.wire_agg import ops, ref

SUM_RTOL = 2.0 ** -21          # 8 ulp of f32 relative to sum|terms|


def _fleet(C, bits, rows=256, seed=0, lost=None):
    rng = np.random.default_rng(seed + C + bits)
    x = (0.02 * rng.standard_normal((C, rows, 128))).astype(np.float32)
    x *= rng.uniform(0.5, 2.0, size=(C, 1, 1)).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, size=C, dtype=np.int32)
    packed, scales = qref.quant_pack_ref(torch.from_numpy(x),
                                         torch.from_numpy(seeds), bits=bits)
    mask = (rng.uniform(size=C) > 0.3).astype(np.float32)
    if lost == "all":
        mask[:] = 0.0
    elif lost == "none":
        mask[:] = 1.0
    weights = rng.uniform(0.2, 1.5, size=C).astype(np.float32)
    return packed, scales, mask, weights


def _bound(packed, scales, weights, bits):
    d = qref.dequant_unpack_ref(packed, scales, bits=bits).numpy()
    return SUM_RTOL * (np.abs(d) * np.abs(weights)[:, None, None]).sum(0)


_CASES = ([(C, "some") for C in (1, 7, 50, 70)]
          + [(50, "none"), (7, "all")])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C,lost", _CASES)
@pytest.mark.parametrize("agg", ["mean", "sum", "median", "trimmed_mean"])
def test_against_jax_ref(bits, C, lost, agg):
    packed, scales, mask, weights = _fleet(C, bits, lost=lost)
    got = ref.wire_agg_ref(packed, scales, torch.from_numpy(mask),
                           torch.from_numpy(weights), bits=bits,
                           aggregator=agg, trim_ratio=0.2).numpy()
    want = np.asarray(jref.wire_agg_ref(
        jnp.asarray(packed.numpy()), jnp.asarray(scales.numpy()),
        jnp.asarray(mask[:, None]), jnp.asarray(weights[:, None]),
        bits=bits, aggregator=agg, trim_ratio=0.2))
    if agg == "median" or lost == "all":
        np.testing.assert_array_equal(got, want)
        return
    tol = _bound(packed, scales, weights, bits)
    if agg == "mean":
        tol = tol / max(float((mask * weights).sum()), 1.0)
    assert np.all(np.abs(got - want) <= tol + 1e-30), \
        np.max(np.abs(got - want) - tol)


@pytest.mark.parametrize("C", [50, 70])
@pytest.mark.parametrize("bits", [8, 4])
def test_wire_aggregate_leaf_against_jax_ops(C, bits):
    """Leaf level, unit weights (the engine route). At C = 70 the JAX ops
    take the two-stage tree mean (chunks of 64); the port's single pass
    differs from it only in summation order."""
    packed, scales, mask, _ = _fleet(C, bits, seed=3)
    shape = (784, 32)
    got = ops.wire_aggregate(packed, scales, torch.from_numpy(mask),
                             shape=shape, bits=bits).numpy()
    want = np.asarray(jops.wire_aggregate(
        jnp.asarray(packed.numpy()), jnp.asarray(scales.numpy()),
        jnp.asarray(mask), shape=shape, bits=bits, interpret=True))
    assert got.shape == shape
    tol = (_bound(packed, scales, np.ones(C, np.float32), bits)
           .reshape(-1)[:784 * 32].reshape(shape)
           / max(float(mask.sum()), 1.0))
    assert np.all(np.abs(got - want) <= tol)


def test_robust_modes_equal_on_duplicates():
    """Ties among equal values: any sort meets the contract."""
    C, bits = 9, 8
    packed, scales, mask, weights = _fleet(C, bits, lost="none")
    packed = packed[:1].repeat(C, 1, 1)
    scales = scales[:1].repeat(C, 1)
    for agg in ("median", "trimmed_mean"):
        got = ref.wire_agg_ref(packed, scales, torch.from_numpy(mask),
                               torch.ones(C), bits=bits, aggregator=agg)
        one = qref.dequant_unpack_ref(packed[:1], scales[:1], bits=bits)[0]
        assert torch.allclose(got, one, rtol=1e-6, atol=0)


# -- the kernel's launch plan and index mapping (kernels/wire_agg/ops.py
# `_plan`, csrc/wire_agg.cu): a CTA per strip of packed rows of one scale
# block, `vec` payload bytes a thread (int4: both nibbles, rows r and
# r + 128 of the block); the C workers' bytes of the strip staged in
# chunks of at most 256 (a TMA box), zero past C. The emulation walks
# that mapping in plain PyTorch with the kernel's arithmetic: the total
# summed in worker order beside the outputs, workers with mask * weight
# = 0 skipped.

def _cta_outputs(plan, bits, rows):
    """(grid, strip, 128 / vec, vec or 2 vec) flat output indices the
    kernel's CTAs write: thread t of CTA x holds bytes vec (t % (128 /
    vec)) .. + vec - 1 of packed row x * strip + t // (128 / vec)."""
    prow = rows // 2 if bits == 4 else rows
    per = 128 // plan.vec                           # threads a packed row
    assert plan.threads == plan.strip * per
    pr = (torch.arange(plan.grid)[:, None] * plan.strip
          + torch.arange(plan.strip)[None, :])                  # (grid, strip)
    lane = torch.arange(per)[None, None, :, None]
    col = plan.vec * lane + torch.arange(plan.vec)
    if bits == 8:
        return pr[..., None, None] * 128 + col, pr
    blk = pr // 128
    lo = (blk * 256 + pr % 128)[..., None, None] * 128 + col
    assert prow == pr.numel()
    return torch.cat([lo, lo + 128 * 128], dim=-1), pr


def _emulate_wire_agg(packed, scales, mask, weights, bits, agg, trim):
    C, prow, _ = packed.shape
    rows = prow * (2 if bits == 4 else 1)
    plan = ops._plan(C, rows, bits, agg)
    idx, pr = _cta_outputs(plan, bits, rows)
    blk = pr[:, 0] // (128 if bits == 4 else 256)               # (grid,)
    # each worker's staged bytes of each strip: chunk by chunk, a box of
    # (chunk, strip, 128) with zeros past C
    stage = []
    for k in range(-(-C // plan.chunk)):
        box = torch.zeros((plan.chunk, prow, 128), dtype=torch.uint8)
        part = packed[k * plan.chunk:(k + 1) * plan.chunk].view(torch.uint8)
        box[:part.shape[0]] = part
        stage.append(box[:C - k * plan.chunk])
    staged = torch.cat(stage).reshape(C, plan.grid, plan.strip,
                                      128 // plan.vec, plan.vec)
    if bits == 8:
        q = staged.view(torch.int8).float()
    else:
        b = staged.to(torch.int32)
        q = torch.cat([(b & 0xF) - 8, (b >> 4) - 8], dim=-1).float()
    d = q * scales[:, blk][:, :, None, None, None]               # f32
    linear = agg in ("mean", "sum")
    mw = mask * weights if linear else weights
    total = torch.zeros(())
    if linear:
        res = torch.zeros(d.shape[1:])
        for c in range(C):                                      # worker order
            if mw[c] == 0:
                continue
            total = total + mw[c]
            res = res + mw[c] * d[c]
        if agg == "mean":
            res = res / torch.clamp(total, min=1.0)
    else:
        for c in range(C):
            total = total + mask[c]
        k = int(total)
        x = torch.where(mask.reshape(C, 1, 1, 1, 1) > 0,
                        d * weights.reshape(C, 1, 1, 1, 1),
                        torch.tensor(float("inf")))
        v = torch.sort(x, dim=0).values
        if k <= 0:
            res = torch.zeros(d.shape[1:])
        elif agg == "median":
            a = (k - 1) // 2
            res = 0.5 * (v[a] + v[k - 1 - a])
        else:
            t = min(int(np.float32(trim) * np.float32(k)), (k - 1) // 2)
            res = torch.zeros(d.shape[1:])
            for c in range(t, k - t):
                res = res + v[c]
            res = res / torch.tensor(float(max(k - 2 * t, 1)))
    out = torch.full((rows * 128,), float("nan"))
    out[idx.reshape(-1)] = res.reshape(-1)
    return out.reshape(rows, 128)


_EMU = ([(C, 256, bits, agg) for C in (1, 50) for bits in (8, 4)
         for agg in ("mean", "sum", "median", "trimmed_mean")]
        + [(C, 256, bits, agg) for C in (65, 300) for bits in (8, 4)
           for agg in ("mean", "sum")]
        + [(3, 8192, 8, "mean"), (3, 8192, 8, "median"),     # strip 8
           (5, 4096, 4, "sum"), (5, 4096, 4, "trimmed_mean")])  # strip 2


@pytest.mark.parametrize("C,rows,bits,agg", _EMU)
def test_kernel_mapping_emulation_is_bitwise_the_plain_version(C, rows, bits,
                                                               agg):
    packed, scales, mask, weights = _fleet(C, bits, rows=rows, seed=9)
    tm, tw = torch.from_numpy(mask), torch.from_numpy(weights)
    got = _emulate_wire_agg(packed, scales, tm, tw, bits, agg, 0.2)
    want = ref.wire_agg_ref(packed, scales, tm, tw, bits=bits,
                            aggregator=agg, trim_ratio=0.2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("C", [1, 50, 64, 65, 256, 257, 300, 4000])
@pytest.mark.parametrize("rows", [256, 4096, 8192, 65536])
@pytest.mark.parametrize("bits", [8, 4])
def test_plan_covers_every_output_once_within_the_card(C, rows, bits):
    plan = ops._plan(C, rows, bits)
    prow = rows // 2 if bits == 4 else rows
    assert plan.strip in (1, 2, 4, 8) and prow % plan.strip == 0
    assert plan.vec in (1, 4)
    assert plan.grid * plan.strip == prow
    assert plan.threads == plan.strip * 128 // plan.vec <= 256
    # a strip never straddles two scale blocks
    assert (128 if bits == 4 else 256) % plan.strip == 0
    nchunks = -(-C // plan.chunk)
    assert 1 <= plan.chunk <= min(C, ops.BOX_MAX)
    assert nchunks * plan.chunk - C < nchunks            # even chunks
    assert plan.stages == (1 if nchunks == 1 else 2)
    assert plan.smem == ops._smem(C, plan.strip, plan.chunk, plan.stages)
    assert plan.smem <= 232_448
    idx, _ = _cta_outputs(plan, bits, rows)
    assert torch.equal(torch.bincount(idx.reshape(-1), minlength=rows * 128),
                       torch.ones(rows * 128, dtype=torch.int64))


@pytest.mark.parametrize("args,match", [
    ((50, 300, 8), "multiple of 256"), ((0, 256, 8), "outside"),
    ((4001, 256, 8), "outside"), ((50, 256, 6), "bits"),
    ((65, 256, 8, "median"), "at most 64")])
def test_plan_rejects_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        ops._plan(*args)
